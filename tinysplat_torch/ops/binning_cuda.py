"""Tile binning as four hand-written kernels, B1-B4, with no host sync.

Counterpart of the XLA binning inside the JAX package's
``bin_splats_dense`` (``tinysplat_tpu/ops/binning.py:88-418``,
``:495-561``): fixed-capacity buffers and device-scalar counters, so that
the host can queue the compositing kernel behind the binning.
``binning.bin_splats_dense`` sends CUDA tensors here (``bin_splats_staged``).

- ``bin_count``: B1 (``csrc/binning.cu``), one thread per depth rank: the
  splat's tile rectangle, ellipse cull and band map, its row count and its
  entry count (the sum of its rows' clipped span lengths).
- ``bin_emit``: B2, one thread per depth rank, with the inclusive scans of
  B1's counts (``torch.cumsum``, as the JAX package's ``jnp.cumsum``): each
  kept entry's (tile id, depth rank) in ``dup_capacity`` buffers, and the
  counters [num_entries, total_intersections, dup_overflow].
- ``radix_hist`` / ``radix_scatter``: B3 and B4, one 8-bit digit pass each
  of a stable LSD radix sort of the entries by tile id (``radix_passes``
  passes); B3's first pass also counts whole tile ids (``full_counts``),
  whose exclusive scan is ``tile_starts``.

Every wrapper launches its kernel on CUDA tensors (counted in
``_build.launches``) or raises; CPU tensors run its plain version, which
computes the same outputs with torch ops (and reads sizes on the host).
Integer outputs are compared bit for bit. Entries past ``num_entries`` in
B2's and B4's intermediate buffers are undefined; ``entry_rank`` is -1 there.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .binning import (BinGeometry, Budgets, DenseBins, depth_order, entry_counters,
                      expand_entries, expand_spans, splat_rects)
from .rasterize_dense import ALPHA_EPS

# B3 / B4: SORT_THREADS threads a block, each taking SORT_ITEMS entries in
# rounds (csrc/binning.cu kSortThreads, kItems); 8-bit digits.
SORT_THREADS, SORT_ITEMS = 256, 8
SORT_TILE = SORT_THREADS * SORT_ITEMS
DIGIT_BITS = 8
DIGITS = 1 << DIGIT_BITS
# Tile grids up to this many tiles count whole tile ids in B3's shared
# memory, larger ones in device memory (csrc/binning.cu kSmemTiles).
SMEM_TILES = 12032


def radix_passes(num_tiles: int) -> int:
    """Digit passes that sort tile ids of ceil(log2(num_tiles + 1)) bits."""
    return max(1, -(-num_tiles.bit_length() // DIGIT_BITS))


def sort_blocks(capacity: int) -> int:
    """B3 / B4 blocks over an entry buffer of ``capacity`` slots."""
    return -(-capacity // SORT_TILE)


def _device_kind(x: torch.Tensor, name: str) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {x.device}")
    return kind


def _recip(v: float) -> float:
    """What torch multiplies by where it divides a float32 CUDA tensor by a
    host scalar: the scalar's reciprocal taken in double, rounded to float32
    (for ALPHA_EPS = 1/255 that is 255.0, not 1 / float32(1/255))."""
    return float(np.float32(1.0 / v))


def _splat_args(order, xys, radii, valid, conics, opacities):
    """B1 / B2's splat inputs as contiguous device tensors of the kernels'
    types; raises on a shape or device they do not take."""
    n, clip = xys.shape[0], conics is not None and opacities is not None
    shapes = {"order": (order, (n,)), "xys": (xys, (n, 2)), "radii": (radii, (n,)),
              "valid": (valid, (n,))}
    if clip:
        shapes.update(conics=(conics, (n, 3)), opacities=(opacities.reshape(-1), (n,)))
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape or x.device != xys.device:
            raise ValueError(f"{name} must be {shape} on {xys.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
    return [order.to(torch.int32).contiguous(), xys.to(torch.float32).contiguous(),
            radii.to(torch.int32).contiguous(), valid.to(torch.bool).contiguous(),
            conics.to(torch.float32).contiguous() if clip else None,
            opacities.reshape(-1).to(torch.float32).contiguous() if clip else None]


def _geom_args(geom: BinGeometry, n: int) -> tuple:
    return (n, geom.tiles_x, geom.tiles_y, geom.row_stride, geom.row_offset,
            float(geom.tile_size), float(geom.tile_size_x), _recip(geom.tile_size),
            _recip(geom.tile_size_x), _recip(ALPHA_EPS))


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The C signature of each entry point of csrc/binning.cu; the stream comes last.
_SIGNATURES = {
    # order, xys, radii, valid, conics, opacities, n, tiles_x, tiles_y, row_stride,
    # row_offset, ts_h, ts_x, inv_ts_h, inv_ts_x, inv_alpha_eps, rows, ents, stream
    "bin_count": (_P,) * 6 + (_I,) * 5 + (_F,) * 5 + (_P,) * 3,
    # ... inv_alpha_eps, rows, ents, rows_incl, ents_incl, dup_capacity,
    # span_capacity, tile_of, rank_of, counters, stream
    "bin_emit": (_P,) * 6 + (_I,) * 5 + (_F,) * 5 + (_P,) * 4 + (_L,) * 2 + (_P,) * 4,
    # keys, counters, shift, blocks, hist, full_counts, num_tiles, stream
    "radix_hist": (_P, _P, _I, _I, _P, _P, _I, _P),
    # keys, vals, hist, incl, counters, shift, blocks, out_keys, out_vals, stream
    "radix_scatter": (_P,) * 5 + (_I,) * 2 + (_P,) * 3,
}


def _launch(symbol: str, device: torch.device, *args) -> None:
    _build.launch("binning", _SIGNATURES[symbol], device, *args, symbol=symbol)


def bin_count_plain(order, xys, radii, valid, geom: BinGeometry, conics=None,
                    opacities=None):
    """B1 in plain PyTorch: (rows, ents), int32 in depth order."""
    rects = splat_rects(xys, radii, valid, geom, conics, opacities)
    o = order.long()
    span_rank, span_len, _, _ = expand_spans(rects, o, geom)
    ents = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    ents.index_add_(0, span_rank, span_len)
    return rects.rows[o].to(torch.int32), ents.to(torch.int32)


def bin_count(order, xys, radii, valid, geom: BinGeometry, conics=None, opacities=None):
    """Each depth rank's row and entry counts (int32): B1 on CUDA tensors
    (``_build.launches["bin_count"]``), ``bin_count_plain`` on CPU
    tensors. ``order`` is the depth order (``binning.depth_order``)."""
    if _device_kind(xys, "bin_count") == "cpu":
        return bin_count_plain(order, xys, radii, valid, geom, conics, opacities)
    n = xys.shape[0]
    ins = _splat_args(order, xys, radii, valid, conics, opacities)
    rows = torch.empty(n, dtype=torch.int32, device=xys.device)
    ents = torch.empty(n, dtype=torch.int32, device=xys.device)
    _launch("bin_count", xys.device, *(_ptr(x) for x in ins), *_geom_args(geom, n),
            rows.data_ptr(), ents.data_ptr())
    return rows, ents


def bin_emit_plain(order, xys, radii, valid, geom: BinGeometry, caps: Budgets, conics=None,
                   opacities=None):
    """B2 in plain PyTorch: (tile_of, rank_of, counters). It recomputes from
    the splats the spans and offsets that B2 takes as B1's counts and their
    scans, and zero-fills the buffers past the kept entries."""
    dev = xys.device
    rects = splat_rects(xys, radii, valid, geom, conics, opacities)
    span_rank, span_len, span_base, total_spans = expand_spans(
        rects, order.long(), geom, caps.span_capacity)
    tile_of, depth_rank, total = expand_entries(span_rank, span_len, span_base,
                                                caps.dup_capacity)
    keys = torch.zeros(caps.dup_capacity, dtype=torch.int32, device=dev)
    vals = torch.zeros(caps.dup_capacity, dtype=torch.int32, device=dev)
    keys[: tile_of.shape[0]] = tile_of.to(torch.int32)
    vals[: tile_of.shape[0]] = depth_rank.to(torch.int32)
    counters = torch.tensor(entry_counters(total, total_spans, caps), dtype=torch.int32,
                            device=dev)
    return keys, vals, counters


def bin_emit(order, xys, radii, valid, geom: BinGeometry, caps: Budgets, rows, ents,
             rows_incl, ents_incl, conics=None, opacities=None):
    """The kept entries in depth order: (tile_of, rank_of) int32 buffers of
    ``dup_capacity`` (defined up to num_entries) and the int32 counters
    [num_entries, total_intersections, dup_overflow]. B2 on CUDA tensors
    (``_build.launches["bin_emit"]``), ``bin_emit_plain`` on CPU tensors.
    ``rows_incl`` / ``ents_incl``: int64 inclusive scans of B1's counts."""
    if _device_kind(xys, "bin_emit") == "cpu":
        return bin_emit_plain(order, xys, radii, valid, geom, caps, conics, opacities)
    n, dev = xys.shape[0], xys.device
    for name, x, dtype in (("rows", rows, torch.int32), ("ents", ents, torch.int32),
                           ("rows_incl", rows_incl, torch.int64),
                           ("ents_incl", ents_incl, torch.int64)):
        if x.dtype != dtype or tuple(x.shape) != (n,) or x.device != dev:
            raise ValueError(f"{name} must be {dtype} ({n},) on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    ins = _splat_args(order, xys, radii, valid, conics, opacities)
    counts = [x.contiguous() for x in (rows, ents, rows_incl, ents_incl)]
    tile_of = torch.empty(caps.dup_capacity, dtype=torch.int32, device=dev)
    rank_of = torch.empty(caps.dup_capacity, dtype=torch.int32, device=dev)
    counters = torch.zeros(3, dtype=torch.int32, device=dev)
    _launch("bin_emit", dev, *(_ptr(x) for x in ins), *_geom_args(geom, n),
            *(x.data_ptr() for x in counts), caps.dup_capacity, caps.span_capacity,
            tile_of.data_ptr(), rank_of.data_ptr(), counters.data_ptr())
    return tile_of, rank_of, counters


def _digits_and_blocks(keys, counters, shift):
    n = int(counters[0])
    k = keys[:n].long()
    blocks = torch.arange(n, device=keys.device) // SORT_TILE
    return k, (k >> shift) & (DIGITS - 1), blocks


def radix_hist_plain(keys, counters, shift: int, blocks: int, full_counts=None):
    """B3 in plain PyTorch: each block's digit counts, digit-major
    (``hist[d * blocks + b]``), over the first ``counters[0]`` keys; adds
    the whole keys' counts into ``full_counts`` when given."""
    k, d, b = _digits_and_blocks(keys, counters, shift)
    hist = torch.bincount(d * blocks + b, minlength=DIGITS * blocks).to(torch.int32)
    if full_counts is not None:
        full_counts += torch.bincount(k, minlength=full_counts.shape[0]).to(torch.int32)
    return hist


def radix_hist(keys, counters, shift: int, blocks: int, full_counts=None):
    """One pass's digit histogram (int32, ``DIGITS * blocks``): B3 on CUDA
    tensors (``_build.launches["radix_hist"]``), ``radix_hist_plain`` on CPU
    tensors. ``counters[0]`` (on the device) is the number of keys."""
    if _device_kind(keys, "radix_hist") == "cpu":
        return radix_hist_plain(keys, counters, shift, blocks, full_counts)
    for name, x in (("keys", keys), ("counters", counters)) + (
            (("full_counts", full_counts),) if full_counts is not None else ()):
        if x.dtype != torch.int32 or not x.is_contiguous() or x.device != keys.device:
            raise ValueError(f"{name} must be a contiguous int32 tensor on {keys.device}")
    hist = torch.empty(DIGITS * blocks, dtype=torch.int32, device=keys.device)
    _launch("radix_hist", keys.device, keys.data_ptr(), counters.data_ptr(), shift, blocks,
            hist.data_ptr(), _ptr(full_counts),
            0 if full_counts is None else full_counts.shape[0])
    return hist


def radix_scatter_plain(keys, vals, hist, incl, counters, shift: int, out_keys, out_vals):
    """B4 in plain PyTorch: the first ``counters[0]`` items to their slots,
    stable by digit. B4's slot of an item, its (digit, block)'s first slot
    from ``incl - hist`` plus its rank among the block's items of that digit
    in input order, is its place in the stable sort by (digit, block)."""
    k, d, b = _digits_and_blocks(keys, counters, shift)
    blocks = hist.shape[0] // DIGITS
    perm = torch.sort(d * blocks + b, stable=True).indices
    n = k.shape[0]
    out_vals[:n] = vals[:n][perm]
    if out_keys is not None:
        out_keys[:n] = keys[:n][perm]


def radix_scatter(keys, vals, hist, incl, counters, shift: int, out_keys, out_vals) -> None:
    """One stable digit pass: writes the first ``counters[0]`` keys (unless
    ``out_keys`` is None) and values to their sorted slots. ``hist`` is
    ``radix_hist``'s, ``incl`` its int32 inclusive scan. B4 on CUDA tensors
    (``_build.launches["radix_scatter"]``), ``radix_scatter_plain`` on CPU
    tensors."""
    if _device_kind(keys, "radix_scatter") == "cpu":
        return radix_scatter_plain(keys, vals, hist, incl, counters, shift, out_keys,
                                   out_vals)
    blocks = hist.shape[0] // DIGITS
    for name, x in (("keys", keys), ("vals", vals), ("hist", hist), ("incl", incl),
                    ("counters", counters), ("out_vals", out_vals)) + (
            (("out_keys", out_keys),) if out_keys is not None else ()):
        if x.dtype != torch.int32 or not x.is_contiguous() or x.device != keys.device:
            raise ValueError(f"{name} must be a contiguous int32 tensor on {keys.device}")
    _launch("radix_scatter", keys.device, keys.data_ptr(), vals.data_ptr(), hist.data_ptr(),
            incl.data_ptr(), counters.data_ptr(), shift, blocks, _ptr(out_keys),
            out_vals.data_ptr())


def sort_by_tile(keys, vals, counters, num_tiles: int, full_counts, out_vals) -> None:
    """Stable LSD radix sort of the first ``counters[0]`` (tile id, value)
    pairs by tile id, ``radix_passes(num_tiles)`` digit passes: the sorted
    values go to ``out_vals``; ``full_counts`` (zeroed, ``num_tiles``)
    receives each tile's count. ``keys`` and ``vals`` serve as scratch."""
    blocks = sort_blocks(keys.shape[0])
    bufs = [(keys, vals), (torch.empty_like(keys), torch.empty_like(vals))]
    passes = radix_passes(num_tiles)
    for p in range(passes):
        src_k, src_v = bufs[p % 2]
        dst_k, dst_v = (None, out_vals) if p == passes - 1 else bufs[(p + 1) % 2]
        shift = DIGIT_BITS * p
        hist = radix_hist(src_k, counters, shift, blocks, full_counts if p == 0 else None)
        incl = torch.cumsum(hist, 0, dtype=torch.int32)
        radix_scatter(src_k, src_v, hist, incl, counters, shift, dst_k, dst_v)


def bin_splats_staged(xys, depths, radii, valid, geom: BinGeometry, caps: Budgets,
                      chunk: int = 128, conics=None, opacities=None) -> DenseBins:
    """``bin_splats_dense`` through the stages B1, B2, B3 / B4: the kernels
    on CUDA tensors, with no host sync (the counters stay on the device),
    and their plain versions composed on CPU tensors."""
    dev = xys.device
    num_tiles = geom.tiles_x * geom.tiles_y
    with torch.no_grad():
        order = depth_order(depths, valid).to(torch.int32)
        rows, ents = bin_count(order, xys, radii, valid, geom, conics, opacities)
        rows_incl, ents_incl = torch.cumsum(rows, 0), torch.cumsum(ents, 0)
        keys, vals, counters = bin_emit(order, xys, radii, valid, geom, caps, rows, ents,
                                        rows_incl, ents_incl, conics, opacities)
        full_counts = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
        entry_rank = torch.full((caps.dup_capacity + chunk,), -1, dtype=torch.int32,
                                device=dev)
        sort_by_tile(keys, vals, counters, num_tiles, full_counts, entry_rank)
        tile_starts = torch.cumsum(full_counts, 0, dtype=torch.int32) - full_counts
        counts = torch.clamp(full_counts, max=caps.max_per_tile)
        tile_overflow = (full_counts - counts).sum(dtype=torch.int32)
    return DenseBins(entry_rank, order, tile_starts, counts, counters[0], counters[1],
                     counters[2], tile_overflow)


def _differ(a, b) -> int:
    """Elements where two integer tensors of one shape differ."""
    return int((a != b).sum())


def stage_mismatch(xys, depths, radii, valid, geom: BinGeometry, caps: Budgets,
                   chunk: int = 128, conics=None, opacities=None) -> dict:
    """Each kernel against its plain version on the same CUDA inputs, stage
    by stage (every stage fed the plain version's output of the one
    before), and the whole layer against ``bin_splats_dense_plain``: the
    elements that differ per stage (0: bit-equal), the first differing
    depth ranks of B1 with their splats, whether two runs of the kernels
    gave the same bytes, and the plain counters."""
    from .binning import bin_splats_dense_plain

    rep = {}
    num_tiles = geom.tiles_x * geom.tiles_y
    with torch.no_grad():
        order = depth_order(depths, valid).to(torch.int32)
        rows, ents = bin_count(order, xys, radii, valid, geom, conics, opacities)
        rows_p, ents_p = bin_count_plain(order, xys, radii, valid, geom, conics, opacities)
        bad = torch.nonzero((rows != rows_p) | (ents != ents_p)).reshape(-1)[:5]
        rep["bin_count"] = _differ(rows, rows_p) + _differ(ents, ents_p)
        rep["bin_count_first"] = [(int(r), int(order[r])) for r in bad]
        scans = (torch.cumsum(rows_p, 0), torch.cumsum(ents_p, 0))
        keys, vals, counters = bin_emit(order, xys, radii, valid, geom, caps, rows_p, ents_p,
                                        *scans, conics, opacities)
        keys_p, vals_p, counters_p = bin_emit_plain(order, xys, radii, valid, geom, caps,
                                                    conics, opacities)
        m = int(counters_p[0])
        rep["bin_emit"] = (_differ(counters, counters_p) + _differ(keys[:m], keys_p[:m])
                           + _differ(vals[:m], vals_p[:m]))
        blocks = sort_blocks(caps.dup_capacity)
        full, full_p = (torch.zeros(num_tiles, dtype=torch.int32, device=xys.device)
                        for _ in range(2))
        src_k, src_v = keys_p.clone(), vals_p.clone()
        rep["radix_hist"] = rep["radix_scatter"] = 0
        for p in range(radix_passes(num_tiles)):
            shift = DIGIT_BITS * p
            hist = radix_hist(src_k, counters_p, shift, blocks, full if p == 0 else None)
            hist_p = radix_hist_plain(src_k, counters_p, shift, blocks,
                                      full_p if p == 0 else None)
            rep["radix_hist"] += _differ(hist, hist_p)
            incl = torch.cumsum(hist_p, 0, dtype=torch.int32)
            outs = [torch.empty_like(src_k) for _ in range(4)]
            radix_scatter(src_k, src_v, hist_p, incl, counters_p, shift, outs[0], outs[1])
            radix_scatter_plain(src_k, src_v, hist_p, incl, counters_p, shift, outs[2],
                                outs[3])
            rep["radix_scatter"] += _differ(outs[0][:m], outs[2][:m]) + _differ(
                outs[1][:m], outs[3][:m])
            src_k, src_v = outs[2], outs[3]
        rep["radix_hist"] += _differ(full, full_p)
        stable = vals_p[:m][torch.sort(keys_p[:m], stable=True).indices]
        rep["sorted_vs_stable_sort"] = _differ(src_v[:m], stable)
        whole = bin_splats_staged(xys, depths, radii, valid, geom, caps, chunk, conics,
                                  opacities)
        again = bin_splats_staged(xys, depths, radii, valid, geom, caps, chunk, conics,
                                  opacities)
        plain = bin_splats_dense_plain(xys, depths, radii, valid, geom, caps, chunk, conics,
                                       opacities)
        rep["whole"] = sum(_differ(a, b) for a, b in zip(whole, plain))
        rep["same_bytes"] = all(torch.equal(a, b) for a, b in zip(whole, again))
        rep["counters"] = {k: int(getattr(plain, k)) for k in (
            "num_entries", "total_intersections", "dup_overflow", "tile_overflow")}
    rep["ok"] = rep["same_bytes"] and not any(
        rep[k] for k in ("bin_count", "bin_emit", "radix_hist", "radix_scatter",
                         "sorted_vs_stable_sort", "whole"))
    return rep
