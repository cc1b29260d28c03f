"""Tile binning: splats -> (tile, depth)-sorted intersection entries.

Torch port of ``tinysplat_tpu.ops.binning.bin_splats_dense``. It keeps that
function's contract slot for slot — the same entries in the same order, the
same capacities, defaults and overflow counters — but not its TPU layout
tricks: the JAX package expands entries with scatters and cumulative-max
fills because XLA:TPU gathers are slow; the plain version here expands with
``torch.repeat_interleave`` and orders with one stable ``torch.sort``.

Semantics (``_sorted_intersections``):

1. Splats are depth-sorted (stable; invalid splats last): ``order``.
2. Each live splat covers a rectangle of tiles (its 3-sigma AABB,
   ``projection.tile_ranges``), tightened — when conics and opacities are
   given — to the ellipse where ``opacity * exp(-sigma) >= 1/255``. That
   cull is exact: a (splat, tile) pair outside the ellipse composites zero.
3. Splats in depth order expand into one span per tile row (at most
   ``span_capacity`` spans; the rest are dropped), and each span into one
   entry per tile of the row, clipped to the ellipse's x-extent over that
   row's pixel band (at most ``dup_capacity`` entries).
4. A stable sort by tile id leaves each tile's entries front to back.

``bin_splats_dense`` dispatches on the device: CUDA tensors go through the
hand-written kernels of ``binning_cuda`` (span count, entry emission, a
stable radix sort by tile), which never wait on the host; CPU tensors run
``bin_splats_dense_plain``, this module's PyTorch version of the whole.
Both return the four counters as 0-d int32 tensors on the input's device,
as the JAX package returns device scalars.

Strided tile-row banding (``row_stride`` S, ``row_offset`` o): one call bins
only the global tile rows {o, o + S, o + 2S, ...} onto a local grid of
``tiles_y`` rows (local row g covers global row o + g S), with ``xys`` in
global pixel coordinates. The sharded trainer round-robins the tile rows of
an image over its ranks this way; S = 1, o = 0 is the whole image.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .projection import tile_ranges
from .rasterize_dense import ALPHA_EPS


class DenseBins(NamedTuple):
    """Unpadded (tile, depth)-sorted intersection layout.

    Tile t's entries occupy ``entry_rank[tile_starts[t]:][:counts[t]]``;
    entries past ``max_per_tile`` stay in the array (the segment's
    farthest) but are left out of ``counts``. One trailing pad chunk
    follows the kept entries, as in the JAX layout. The counters are 0-d
    int32 tensors on the input's device (``int()`` fetches one).
    """

    entry_rank: torch.Tensor  # (dup_capacity + chunk,) int32 DEPTH RANKS, -1 pad
    order: torch.Tensor  # (N,) int32 depth sort: original id = order[rank]
    tile_starts: torch.Tensor  # (num_tiles,) int32 segment start per tile
    counts: torch.Tensor  # (num_tiles,) int32 clamped to max_per_tile
    num_entries: torch.Tensor  # () int32 kept entries (<= dup_capacity)
    total_intersections: torch.Tensor  # () int32 before the dup_capacity clamp
    dup_overflow: torch.Tensor  # () int32 entries dropped by dup_capacity / span_capacity
    tile_overflow: torch.Tensor  # () int32 entries dropped by max_per_tile


class BinGeometry(NamedTuple):
    """The tile grid one call bins onto (``tiles_y``: the band's rows)."""

    tiles_x: int
    tiles_y: int
    tile_size: int  # tile height in pixels
    tile_size_x: int  # tile width in pixels
    row_stride: int = 1
    row_offset: int = 0


class Budgets(NamedTuple):
    """The capacities of one call, after the defaults and rounding."""

    dup_capacity: int
    max_per_tile: int
    span_capacity: int


def budgets(n: int, num_tiles: int, chunk: int, dup_capacity: int = 0, max_per_tile: int = 0,
            span_capacity: int = 0) -> Budgets:
    """Defaults and rounding as in the JAX package: ``dup_capacity`` 8*N
    rounded up to ``chunk``; ``max_per_tile`` min(4096, max(dup_capacity /
    num_tiles, 2*chunk)) rounded up to ``chunk``; ``span_capacity``
    max(dup_capacity // 2, 2*N)."""
    if dup_capacity <= 0:
        dup_capacity = 8 * n
    dup_capacity = (dup_capacity + chunk - 1) // chunk * chunk
    if max_per_tile <= 0:
        max_per_tile = min(4096, max(dup_capacity // max(num_tiles, 1), 2 * chunk))
    max_per_tile = (max_per_tile + chunk - 1) // chunk * chunk
    if span_capacity <= 0:
        span_capacity = max(dup_capacity // 2, 2 * n)
    return Budgets(dup_capacity, max_per_tile, span_capacity)


def _ellipse_constants(xys, conics, opacities):
    """Per-splat constants of the exact alpha-test ellipse cull.

    conic = [A, B, C]; sigma(d) = 0.5 (A dx^2 + C dy^2) + B dx dy <= t_s with
    t_s = log(opacity / ALPHA_EPS). The x half-extent at offset dy is
    f(dy) = p1*dy + inva*sqrt(k1*dy^2 + k2), concave, maximal at dystar.
    """
    A = torch.clamp(conics[:, 0], min=1e-12)
    B = conics[:, 1]
    C = torch.clamp(conics[:, 2], min=1e-12)
    op = opacities.reshape(-1).to(torch.float32)
    t_s = torch.log(torch.clamp(op, min=1e-30) / ALPHA_EPS)
    det = torch.clamp(A * C - B * B, min=1e-20)
    t2 = 2.0 * torch.clamp(t_s, min=0.0)
    return dict(
        t_s=t_s,
        dymax=torch.sqrt(t2 * A / det),  # ellipse y half-extent (pixels)
        dxg=torch.sqrt(t2 * C / det),  # ellipse x half-extent (global max)
        p1=-B / A,
        k1=-det,
        k2=t2 * A,
        inva=1.0 / A,
        dystar=-B * torch.sqrt(t2 / (C * det)),
        cx=xys[:, 0].to(torch.float32),
        cy=xys[:, 1].to(torch.float32),
    )


def _span_extent(e, tile_row, ts_f, ts_x, bx0, width):
    """First tile column and length of each span, clipped to the ellipse's
    x-extent over the span's 16-px row band (``e``: per-span constants)."""
    dy0 = tile_row * ts_f - e["cy"]
    dy1 = dy0 + (ts_f - 1.0)

    def f_of(dy):  # x half-extent of the ellipse at offset dy
        return e["p1"] * dy + e["inva"] * torch.sqrt(
            torch.clamp(e["k1"] * dy * dy + e["k2"], min=0.0))

    def band_max(lo, hi):  # max of concave f over [lo, hi]
        lo_c = torch.minimum(torch.maximum(lo, -e["dymax"]), e["dymax"])
        hi_c = torch.minimum(torch.maximum(hi, -e["dymax"]), e["dymax"])
        inside = (e["dystar"] >= lo_c) & (e["dystar"] <= hi_c)
        return torch.where(inside, e["dxg"], torch.maximum(f_of(lo_c), f_of(hi_c)))

    dx_hi = band_max(dy0, dy1)
    dx_lo = -band_max(-dy1, -dy0)  # min of x extent = -max of mirrored f
    x_last = bx0 + width - 1.0  # inclusive last tile of the rect
    tx0 = torch.minimum(torch.maximum(torch.floor((e["cx"] + dx_lo) / ts_x), bx0), x_last)
    tx1 = torch.minimum(torch.maximum(torch.floor((e["cx"] + dx_hi) / ts_x), tx0), x_last)
    return tx0, tx1 - tx0 + 1.0


class SplatRects(NamedTuple):
    """Each splat's tile rectangle on the band's grid (original order)."""

    bx0: torch.Tensor  # (N,) int32 first tile column
    widths: torch.Tensor  # (N,) int32 columns, >= 0
    by0: torch.Tensor  # (N,) int32 first LOCAL tile row
    rows: torch.Tensor  # (N,) int32 covered rows; 0 for a culled splat
    ellipse: Optional[dict]  # _ellipse_constants, or None without conics


def splat_rects(xys, radii, valid, geom: BinGeometry, conics=None,
                opacities=None) -> SplatRects:
    """Steps 2 and the band map of the module docstring: each splat's 3-sigma
    tile rectangle, tightened to its alpha ellipse when conics and
    opacities are given (splats with t_s <= 0 cover nothing), its global
    rows mapped onto the band's local rows."""
    stride, offset = geom.row_stride, geom.row_offset
    ts_f, ts_x = float(geom.tile_size), float(geom.tile_size_x)
    # Rects clamp against the GLOBAL row range, then map to local rows.
    bx0, bx1, by0, by1 = tile_ranges(xys, radii, geom.tiles_x, geom.tiles_y * stride,
                                     geom.tile_size, tile_size_x=geom.tile_size_x)
    e = None
    alive = valid
    if conics is not None and opacities is not None:
        e = _ellipse_constants(xys, conics, opacities)
        bx0 = torch.maximum(bx0, torch.floor((e["cx"] - e["dxg"]) / ts_x).to(torch.int32))
        bx1 = torch.minimum(bx1, torch.floor((e["cx"] + e["dxg"]) / ts_x).to(torch.int32) + 1)
        by0 = torch.maximum(by0, torch.floor((e["cy"] - e["dymax"]) / ts_f).to(torch.int32))
        by1 = torch.minimum(by1, torch.floor((e["cy"] + e["dymax"]) / ts_f).to(torch.int32) + 1)
        alive = valid & (e["t_s"] > 0.0)
    if stride != 1:
        # Global rows [by0, by1) -> local rows [g0, g1): the ceil and the
        # floor of (row - o) / S, as floor divisions.
        by0 = torch.clamp(-((offset - by0) // stride), 0, geom.tiles_y)
        by1 = torch.clamp((by1 - 1 - offset) // stride + 1, 0, geom.tiles_y)
    # Differences in int64: where a coordinate saturates the int32 cast (a
    # splat ~2^31 tiles off the image) an int32 difference would wrap to a
    # span off the grid; here such a splat covers nothing.
    widths = torch.clamp(bx1.long() - bx0, min=0).to(torch.int32)
    rows = torch.where(alive & (widths > 0), torch.clamp(by1.long() - by0, min=0), 0)
    return SplatRects(bx0, widths, by0, rows.to(torch.int32), e)


def depth_order(depths, valid) -> torch.Tensor:
    """Step 1: the stable depth sort, invalid splats last (int64 ids)."""
    return torch.sort(torch.where(valid, depths, torch.inf), stable=True).indices


def expand_spans(rects: SplatRects, order, geom: BinGeometry, span_capacity: Optional[int] = None):
    """Steps 4 and 5: one span per covered tile row of the splats in depth
    order ``order``, the first ``span_capacity`` of them (all without one).
    Returns (span_rank, span_len, span_base, total_spans): each span's depth
    rank, its entry count and first tile id (int64), and the spans before
    the cut."""
    dev = order.device
    i64 = torch.int64
    n = order.shape[0]
    rows_o = rects.rows[order].to(i64)
    width_o = torch.clamp(rects.widths, min=1)[order].to(torch.float32)
    bx0_o = rects.bx0[order].to(torch.float32)
    by0_o = rects.by0[order].to(torch.float32)
    starts1 = torch.cumsum(rows_o, 0) - rows_o
    total_spans = int(rows_o.sum())
    kept = total_spans if span_capacity is None else min(total_spans, span_capacity)
    span_rank = torch.repeat_interleave(
        torch.arange(n, device=dev), rows_o, output_size=total_spans)[:kept]
    row_idx = torch.arange(kept, device=dev) - starts1[span_rank]
    tile_row = by0_o[span_rank] + row_idx.to(torch.float32)
    sp_bx0 = bx0_o[span_rank]
    if rects.ellipse is not None:
        es = {k: v[order][span_rank] for k, v in rects.ellipse.items() if k != "t_s"}
        # The ellipse lives in global pixels: local rows map back.
        row_g = tile_row
        if geom.row_stride != 1:
            row_g = tile_row * float(geom.row_stride) + float(geom.row_offset)
        tx0, span_len_f = _span_extent(es, row_g, float(geom.tile_size),
                                       float(geom.tile_size_x), sp_bx0, width_o[span_rank])
    else:
        tx0, span_len_f = sp_bx0, width_o[span_rank]
    span_len = span_len_f.to(i64)
    span_base = (tile_row * geom.tiles_x + tx0).to(i64)
    return span_rank, span_len, span_base, total_spans


def expand_entries(span_rank, span_len, span_base, dup_capacity: int):
    """Step 6: each kept span -> one entry per tile, the first
    ``dup_capacity`` of them, in depth order. Returns (tile_of, depth_rank,
    total): the entries' tile ids and depth ranks (int64) and the entry
    total before the cut."""
    dev = span_rank.device
    starts2 = torch.cumsum(span_len, 0) - span_len
    total = int(span_len.sum())
    kept = min(total, dup_capacity)
    entry_span = torch.repeat_interleave(
        torch.arange(span_rank.shape[0], device=dev), span_len, output_size=total)[:kept]
    tile_of = span_base[entry_span] + (torch.arange(kept, device=dev) - starts2[entry_span])
    return tile_of, span_rank[entry_span], total


def entry_counters(total: int, total_spans: int, caps: Budgets) -> Tuple[int, int, int]:
    """(num_entries, total_intersections, dup_overflow) of ``total`` entries
    in the kept spans of ``total_spans``. Dropped spans never materialize:
    their entries count at the mean kept-span width (ceil), as the JAX
    package counts them."""
    span_overflow = max(total_spans - caps.span_capacity, 0)
    if span_overflow:
        kept_spans = min(total_spans, caps.span_capacity)
        mean_w = -(-total // kept_spans) if kept_spans > 0 else 1
        span_overflow *= max(mean_w, 1)
    return (min(total, caps.dup_capacity), total,
            max(total - caps.dup_capacity, 0) + span_overflow)


def bin_splats_dense_plain(xys, depths, radii, valid, geom: BinGeometry, caps: Budgets,
                           chunk: int = 128, conics=None, opacities=None) -> DenseBins:
    """The whole binning in plain PyTorch (the module docstring's steps 1-10;
    ``caps`` resolved by ``budgets``). It reads its sizes on the host."""
    dev = xys.device
    with torch.no_grad():
        rects = splat_rects(xys, radii, valid, geom, conics, opacities)
        order = depth_order(depths, valid)
        span_rank, span_len, span_base, total_spans = expand_spans(
            rects, order, geom, caps.span_capacity)
        tile_of, depth_rank, total = expand_entries(span_rank, span_len, span_base,
                                                    caps.dup_capacity)
        # Entries are generated in depth order, so one stable sort by tile
        # leaves every tile's entries front to back.
        sorted_tile, perm = torch.sort(tile_of, stable=True)
        sorted_rank = depth_rank[perm]
        num_tiles = geom.tiles_x * geom.tiles_y
        tile_starts = torch.searchsorted(
            sorted_tile, torch.arange(num_tiles, device=dev, dtype=torch.int64))
        tile_ends = torch.cat([tile_starts[1:], tile_starts.new_tensor([sorted_tile.shape[0]])])
        full_counts = tile_ends - tile_starts
        counts = torch.clamp(full_counts, max=caps.max_per_tile)
        entry_rank = torch.full((caps.dup_capacity + chunk,), -1, dtype=torch.int32, device=dev)
        entry_rank[: sorted_rank.shape[0]] = sorted_rank.to(torch.int32)
    num_entries, total, dup_overflow = entry_counters(total, total_spans, caps)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return DenseBins(
        entry_rank=entry_rank,
        order=order.to(torch.int32),
        tile_starts=tile_starts.to(torch.int32),
        counts=counts.to(torch.int32),
        num_entries=scalar(num_entries),
        total_intersections=scalar(total),
        dup_overflow=scalar(dup_overflow),
        tile_overflow=(full_counts - counts).sum().to(torch.int32),
    )


def bin_splats_dense(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    valid: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    tile_size: int = 16,
    chunk: int = 128,
    dup_capacity: int = 0,
    max_per_tile: int = 0,
    span_capacity: int = 0,
    conics: Optional[torch.Tensor] = None,
    opacities: Optional[torch.Tensor] = None,
    row_stride: int = 1,
    row_offset=0,
    tile_size_x: int = 0,
) -> DenseBins:
    """Build the unpadded dense intersection layout (see DenseBins).

    Capacities as ``budgets`` resolves them. ``row_stride`` /
    ``row_offset``: the strided band of the module docstring (``tiles_y`` is
    the band's rows). CUDA tensors run the kernels of ``binning_cuda``
    (no host sync), CPU tensors ``bin_splats_dense_plain``; any other
    device raises.
    """
    if row_stride < 1 or not 0 <= int(row_offset) < row_stride:
        raise ValueError(f"row_offset must lie in [0, row_stride), got stride {row_stride}, "
                         f"offset {row_offset}")
    geom = BinGeometry(tiles_x, tiles_y, tile_size, tile_size_x or tile_size, row_stride,
                       int(row_offset))
    caps = budgets(xys.shape[0], tiles_x * tiles_y, chunk, dup_capacity, max_per_tile,
                   span_capacity)
    if xys.device.type == "cpu":
        return bin_splats_dense_plain(xys, depths, radii, valid, geom, caps, chunk, conics,
                                      opacities)
    if xys.device.type != "cuda":
        raise ValueError(f"bin_splats_dense runs on CUDA or CPU tensors, not {xys.device}")
    from . import binning_cuda  # it builds on this module

    return binning_cuda.bin_splats_staged(xys, depths, radii, valid, geom, caps, chunk,
                                          conics, opacities)
