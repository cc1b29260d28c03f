"""A first-party msgpack codec for flax's ``to_bytes`` checkpoints.

``flax.serialization.to_bytes(params)`` writes the parameter tree as
msgpack: nested maps with string keys, and each array as msgpack
extension type 1 whose payload is itself msgpack, the array
``(shape, dtype name, raw C-order bytes)``. Arrays above 2**30 bytes are
split into chunks; this codec refuses those (a tiny-topology pipeline
holds none). It reads and writes that subset only (maps, strings,
non-negative ints, arrays, bin, the ndarray extension) and raises on
anything else.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

NDARRAY_EXT = 1
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_WIDTHS = ((">B", 1 << 8), (">H", 1 << 16), (">I", 1 << 32))


def _head(out: bytearray, n: int, fix_base, fix_limit: int, codes) -> None:
    """A length or value header: the fix form below ``fix_limit``, else the
    narrowest of ``codes`` (8 / 16 / 32-bit; None where msgpack has none)."""
    if fix_base is not None and n < fix_limit:
        out += bytes([fix_base | n])
        return
    for code, (fmt, top) in zip(codes, _WIDTHS):
        if code is not None and n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise OverflowError(f"{n} does not fit the msgpack subset")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or (isinstance(obj, int) and obj < 0):
        raise TypeError(f"cannot pack {obj!r}")
    if isinstance(obj, int):
        if obj >= 1 << 32:
            out += b"\xcf" + struct.pack(">Q", obj)
        else:
            _head(out, obj, 0x00, 128, (0xcc, 0xcd, 0xce))
    elif isinstance(obj, str):
        raw = obj.encode()
        _head(out, len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += raw
    elif isinstance(obj, bytes):
        _head(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.nbytes > 1 << 30:
            raise ValueError("object arrays and arrays above 2**30 bytes are not written")
        payload = packb([list(obj.shape), obj.dtype.name, np.ascontiguousarray(obj).tobytes()])
        if len(payload) in _FIXEXT:
            out += bytes([_FIXEXT[len(payload)]])
        else:
            _head(out, len(payload), None, 0, (0xc7, 0xc8, 0xc9))
        out += bytes([NDARRAY_EXT]) + payload
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_UINTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
# Type byte -> (width of its length field, kind).
_SIZED = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"), 0xde: (">H", "map"),
          0xdf: (">I", "map"), 0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
_FIXEXT_LEN = {code: n for n, code in _FIXEXT.items()}


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    b = buf[i]
    i += 1
    if b < 0x80:
        return b, i
    if b <= 0x8f:
        return _collect(buf, i, b & 0x0f, "map")
    if b <= 0x9f:
        return _collect(buf, i, b & 0x0f, "array")
    if b <= 0xbf:
        return _bytes(buf, i, b & 0x1f, "str")
    if b in _UINTS:
        n = struct.calcsize(_UINTS[b])
        return struct.unpack(_UINTS[b], buf[i:i + n])[0], i + n
    if b in _FIXEXT_LEN:
        return _bytes(buf, i, _FIXEXT_LEN[b], "ext")
    if b in _SIZED:
        fmt, kind = _SIZED[b]
        w = struct.calcsize(fmt)
        (n,) = struct.unpack(fmt, buf[i:i + w])
        if kind in ("array", "map"):
            return _collect(buf, i + w, n, kind)
        return _bytes(buf, i + w, n, kind)
    raise ValueError(f"msgpack type byte 0x{b:02x} is not in the subset flax writes")


def _bytes(buf, i, n, kind):
    if kind == "ext":
        if buf[i] != NDARRAY_EXT:
            raise ValueError(f"msgpack extension type {buf[i]} is not an array")
        shape, dtype, raw = unpackb(bytes(buf[i + 1:i + 1 + n]))
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy(), i + 1 + n
    raw = bytes(buf[i:i + n])
    return (raw.decode() if kind == "str" else raw), i + n


def _collect(buf, i, n, kind):
    items = []
    for _ in range(2 * n if kind == "map" else n):
        x, i = _unpack(buf, i)
        items.append(x)
    return (dict(zip(items[::2], items[1::2])) if kind == "map" else items), i


def unpackb(data: bytes):
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the msgpack object")
    return obj


def to_bytes(tree: Dict[str, Any]) -> bytes:
    """``flax.serialization.to_bytes`` of a nested dict of numpy arrays."""
    return packb(tree)


def from_bytes(data: bytes) -> Dict[str, Any]:
    """The nested dict of numpy arrays that ``flax.serialization.to_bytes``
    wrote."""
    tree = unpackb(data)

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError("chunked arrays (above 2**30 bytes) are not read")
            for v in node.values():
                check(v)

    check(tree)
    return tree
