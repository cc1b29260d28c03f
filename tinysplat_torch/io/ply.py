"""Minimal binary-little-endian PLY writer/reader (numpy only; a copy of
``tinysplat_tpu.io.ply``).

Replaces the reference's `plyfile` dependency
(its tinysplat/splatting/model_gaussian.py:15, used at :330-361).
Supports exactly what the splat/mesh exporters need: one or more elements of
float32/float64/int32/uint8 scalar properties plus triangle-list faces.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "float16": "<f2", "half": "<f2",
    "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "int64": "<i8", "uint64": "<u8",
    "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "ushort": "<u2", "int16": "<i2", "uint16": "<u2",
    "char": "i1", "uchar": "u1", "uint8": "u1", "int8": "i1",
}
_NAMES = {np.dtype(v): k for k, v in [
    ("float", "<f4"), ("double", "<f8"), ("int", "<i4"), ("uint", "<u4"),
    ("short", "<i2"), ("ushort", "<u2"), ("char", "i1"), ("uchar", "u1"),
]}


def write_ply(
    path: str,
    vertex: np.ndarray,
    faces: Optional[np.ndarray] = None,
    comments: Tuple[str, ...] = (),
) -> None:
    """Write a binary PLY. `vertex` is a structured array (one field per
    property); `faces` is an optional (F, 3) int array of triangle indices."""
    header: List[str] = ["ply", "format binary_little_endian 1.0"]
    header += [f"comment {c}" for c in comments]
    header.append(f"element vertex {len(vertex)}")
    for name in vertex.dtype.names:
        if vertex.dtype[name].shape:
            # A sub-array field would make the header (one scalar property)
            # disagree with tobytes() (all sub-elements) — every reader
            # would misparse the payload with no error from us.
            raise ValueError(
                f"vertex field {name!r} has sub-array shape "
                f"{vertex.dtype[name].shape}; flatten to scalar fields "
                f"(e.g. x/y/z) before writing")
        header.append(f"property {_NAMES[vertex.dtype[name].base]} {name}")
    if faces is not None:
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(vertex.tobytes())
        if faces is not None:
            faces = np.asarray(faces, "<i4")
            rec = np.empty(
                len(faces), dtype=np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
            )
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a binary-little-endian PLY; returns {element_name: structured
    array}. Face lists are returned as an (F, 3) 'vertex_indices' field
    (fixed-count triangle lists only)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = f.readline().split()
        if fmt[1] != b"binary_little_endian":
            raise ValueError("only binary_little_endian PLY supported")

        elements: List[Tuple[str, int, List[Tuple[str, str]], Optional[Tuple[str, str, str]]]] = []
        while True:
            line = f.readline().decode("ascii").strip()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "comment":
                continue
            if parts[0] == "element":
                elements.append((parts[1], int(parts[2]), [], None))
            elif parts[0] == "property":
                name, count, props, listprop = elements[-1]
                if parts[1] == "list":
                    elements[-1] = (name, count, props, (parts[2], parts[3], parts[4]))
                else:
                    props.append((parts[2], _DTYPES[parts[1]]))

        out: Dict[str, np.ndarray] = {}
        for name, count, props, listprop in elements:
            if listprop is None:
                dt = np.dtype(props)
                raw = f.read(dt.itemsize * count)
                if len(raw) != dt.itemsize * count:
                    raise ValueError(
                        f"truncated PLY: element {name!r} declares {count} "
                        f"records but only {len(raw) // dt.itemsize} are "
                        f"present")
                out[name] = np.frombuffer(raw, dtype=dt)
            else:
                cnt_dt, idx_dt = np.dtype(_DTYPES[listprop[0]]), np.dtype(_DTYPES[listprop[1]])
                # Fixed-length lists only (triangles): peek the first count,
                # consume exactly this element's bytes (elements may follow),
                # and verify every record matches — a mixed tri/quad file
                # would otherwise misalign into garbage indices silently.
                head = f.read(cnt_dt.itemsize)
                if len(head) < cnt_dt.itemsize:
                    raise ValueError(f"truncated PLY: element {name!r} empty")
                n0 = int(np.frombuffer(head, cnt_dt)[0])
                rec = np.dtype([("n", cnt_dt), ("vertex_indices", idx_dt, (n0,))])
                raw = head + f.read(rec.itemsize * count - cnt_dt.itemsize)
                if len(raw) != rec.itemsize * count:
                    raise ValueError(
                        f"truncated PLY: element {name!r} declares {count} "
                        f"list records")
                arr = np.frombuffer(raw, dtype=rec)
                if not (arr["n"] == n0).all():
                    raise ValueError(
                        f"PLY element {name!r} has variable-length lists "
                        f"(first={n0}); only fixed-count lists (triangle "
                        f"meshes) are supported")
                out[name] = arr
        return out
