"""Splat model exporters: PLY (3DGS-standard), .splat, OBJ mesh.

Torch port of ``tinysplat_tpu.io.export`` over the port's ``state_dict`` /
``from_state_dict``. The files are byte-identical to the JAX package's for
the same state (the PLY header carries the same comment):

- export_ply: the de-facto-standard 3DGS vertex layout (x y z, zero normals,
  f_dc_*, channel-major f_rest_*, opacity, scale_*, rot_*), loadable by
  public 3DGS viewers and by either package's ``import_ply``;
- export_splat: the antimatter15 .splat packed format;
- export_mesh_obj: the OBJ triangle-mesh writer of the mesh-extraction path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.gaussians import GaussianState, from_state_dict, state_dict
from .ply import read_ply, write_ply

# The JAX package's writer comment, kept so that both write the same bytes.
PLY_COMMENT = "generated by tinysplat-tpu"


def export_ply(state: GaussianState, filepath: str) -> None:
    """Write live splats in the standard 3DGS PLY layout (f_rest is
    channel-major: colors_rest transposed to (3, K-1) per splat before
    flattening)."""
    sd = state_dict(state)
    n = sd["means"].shape[0]
    k_rest = sd["colors_rest"].shape[1]

    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * k_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]

    cols = np.concatenate(
        [
            sd["means"],
            np.zeros_like(sd["means"]),
            sd["colors_dc"],
            sd["colors_rest"].transpose(0, 2, 1).reshape(n, -1),
            sd["opacities"],
            sd["scales"],
            sd["quats"],
        ],
        axis=1,
    ).astype("<f4")

    vertex = np.empty(n, dtype=[(name, "<f4") for name in names])
    for i, name in enumerate(names):
        vertex[name] = cols[:, i]
    write_ply(filepath, vertex, comments=(PLY_COMMENT,))


def import_ply(filepath: str, capacity: Optional[int] = None, device="cuda") -> GaussianState:
    """Load a 3DGS-layout PLY back into a GaussianState on ``device``."""
    vertex = read_ply(filepath)["vertex"]
    names = vertex.dtype.names
    n_rest = sum(1 for f in names if f.startswith("f_rest_"))
    k_rest = n_rest // 3

    def grab(prefix, count):
        return np.stack([vertex[f"{prefix}{i}"] for i in range(count)], axis=1)

    sd = {
        "means": np.stack([vertex["x"], vertex["y"], vertex["z"]], axis=1),
        "colors_dc": grab("f_dc_", 3),
        "colors_rest": grab("f_rest_", n_rest).reshape(-1, 3, k_rest).transpose(0, 2, 1)
        if n_rest
        else np.zeros((len(vertex), 0, 3), np.float32),
        "opacities": vertex["opacity"][:, None],
        "scales": grab("scale_", 3),
        "quats": grab("rot_", 4),
    }
    sd = {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}
    return from_state_dict(sd, capacity=capacity, device=device)


# SH band-0 constant (utils/color.py).
_C0 = 0.28209479177387814


def export_splat(state: GaussianState, filepath: str) -> None:
    """Write the antimatter15 .splat packed format (32 bytes per splat:
    3xf32 position, 3xf32 scale, 4xu8 RGBA, 4xu8 quaternion), sorted by
    opacity-weighted volume as the canonical exporter does."""
    sd = state_dict(state)
    scales = np.exp(sd["scales"])
    opac = 1.0 / (1.0 + np.exp(-sd["opacities"][:, 0]))
    rgb = np.clip(sd["colors_dc"] * _C0 + 0.5, 0.0, 1.0)
    quats = sd["quats"]
    quats = quats / np.maximum(np.linalg.norm(quats, axis=1, keepdims=True), 1e-12)

    order = np.argsort(-(scales.prod(axis=1) * opac))
    n = len(order)
    rec = np.empty(n, dtype=[("pos", "<f4", 3), ("scale", "<f4", 3),
                             ("rgba", "u1", 4), ("rot", "u1", 4)])
    rec["pos"] = sd["means"][order]
    rec["scale"] = scales[order]
    rec["rgba"][:, :3] = (rgb[order] * 255).astype(np.uint8)
    rec["rgba"][:, 3] = (opac[order] * 255).astype(np.uint8)
    rec["rot"] = np.clip(quats[order] * 128 + 128, 0, 255).astype(np.uint8)
    with open(filepath, "wb") as f:
        f.write(rec.tobytes())


def export_mesh_obj(filepath: str, vertices: np.ndarray, faces: np.ndarray,
                    normals: Optional[np.ndarray] = None) -> None:
    """Plain OBJ triangle-mesh writer."""
    with open(filepath, "w") as f:
        f.write(f"# {PLY_COMMENT}\n")
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if normals is not None:
            for vn in normals:
                f.write(f"vn {vn[0]:.6f} {vn[1]:.6f} {vn[2]:.6f}\n")
        for tri in np.asarray(faces) + 1:
            if normals is not None:
                f.write(f"f {tri[0]}//{tri[0]} {tri[1]}//{tri[1]} {tri[2]}//{tri[2]}\n")
            else:
                f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
