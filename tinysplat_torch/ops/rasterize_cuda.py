"""Tile rasterizer: binning + the hand-written compositing kernels.

Counterpart of ``tinysplat_tpu.ops.rasterize_pallas``. ``rasterize_cuda``
has ``rasterize_pallas``'s signature, outputs, diagnostics and gradients:

1. ``tile_inputs``: ``bin_splats_dense`` lays every tile's depth-sorted
   entries out contiguously (entry ids are depth RANKS); the per-splat
   attribute table is permuted by the depth order, so entry ranks index it
   directly, and a zero SENTINEL row follows it (opacity 0 => no
   contribution). A tile is ``tile_h`` rows by ``tile_x`` columns (the JAX
   package's ``tile_size`` and ``tile_x``). Per-tile pixel origins
   ``sx``/``sy``: with a strided band (``row_stride`` S, ``row_offset`` o)
   local tile row g starts at global pixel row (o + g S) * tile_h, so the
   kernels composite global coordinates.
2. ``composite_fwd``: K1 (``csrc/composite_fwd.cu``) on CUDA tensors, its
   plain PyTorch version ``composite_fwd_plain`` on CPU tensors. Output:
   (num_tiles, 8, tile_h * tile_x) f32 rows [c0..c3, T_final, n_contrib,
   last_contrib, 0], the JAX kernel's OUT_ROWS layout.
3. ``untile``: background blend by T_final, tiles -> (H, W) image (a
   band's rows stay in band order).

The backward (``loss.backward()`` reaches it through ``composite_tiles``, a
``torch.autograd.Function`` around K1):

4. ``composite_bwd``: K2 (``csrc/composite_bwd.cu``) on CUDA tensors,
   ``composite_bwd_plain`` on CPU tensors. Per-entry gradient rows
   (len(entry_rank), 10) of the table columns, zero past each tile's live
   prefix.
5. ``table_grad``: per-entry rows -> per-splat rows of the table and its
   zero sentinel row, by one of the JAX package's four ``grad_reduce``
   strategies; ``"scatter"`` adds each live slot's row into its splat's
   with ``scatter_rows`` (``csrc/scatter_rows.cu``), and ``"mxu"`` sorts by
   id and sums each splat's run with K3 (``csrc/segsum.cu``, ``segsum``),
   which reads the rows through the sort's permutation.
6. Autograd carries the table gradient back through the depth-order
   permutation, projection, SH and the opacity sigmoid.

Every kernel wrapper launches its kernel on CUDA tensors (counted in
``_build.launches``) or raises; CPU tensors run the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..utils.profiling import op_range, span
from . import _build
from .binning import DenseBins, bin_splats_dense
from .rasterize_dense import ALPHA_EPS, ALPHA_MAX, T_EPS

OUT_ROWS = 8  # [c0..c3, T_final, n_contrib, last_contrib, 0]
TABLE_COLS = 10  # [x, y, conic a, b, c, opacity, c0..c3]
# K1 and K2 run one block per SUB_H x SUB_X sub-tile of a tile, one thread per
# pixel; a warp's 32 pixels are an 8 x 4 patch (WARP_FOOTPRINT, width x height).
# A tile_h x tile_x tile is ceil(tile_h / SUB_H) x ceil(tile_x / SUB_X)
# sub-tiles, row by row; in a ragged last one the threads past the tile's
# edge composite nothing. The wrappers pass SUB_X to the kernels, which
# refuse a launch unless it is the width they were built with
# (csrc/composite_common.cuh: kSubX; kTileH is SUB_H).
SUB_H = SUB_X = 16
SUB_THREADS = SUB_H * SUB_X
WARP_FOOTPRINT = (8, 4)
GRAD_REDUCE = ("scatter", "sorted", "segment", "mxu")
# The plain version walks blocks of tiles holding about this many pixels at
# a time (so it fits in memory at any image size), and tests every this many
# entries whether any pixel of the block is still live.
_PLAIN_BLOCK_ELEMS = 1 << 22
_PLAIN_LIVE_CHECK = 32


class TileInputs(NamedTuple):
    """Everything K1 reads, plus the tile grid it was built for."""

    table: torch.Tensor  # (N + 1, TABLE_COLS) f32, depth order + sentinel
    entry_rank: torch.Tensor  # (dup_capacity + chunk,) int32 depth ranks, -1 pad
    tile_starts: torch.Tensor  # (num_tiles,) int32
    counts: torch.Tensor  # (num_tiles,) int32
    sx: torch.Tensor  # (num_tiles,) int32 tile pixel origin x
    sy: torch.Tensor  # (num_tiles,) int32 tile pixel origin y
    tile_x: int
    tile_h: int
    tiles_x: int
    tiles_y: int
    bins: DenseBins


def tile_inputs(xys, depths, radii, conics, colors, opacities, valid,
                img_height: int, img_width: int, chunk: int = 128,
                dup_capacity: int = 0, max_per_tile: int = 0,
                span_capacity: int = 0, tile_x: int = 16, row_stride: int = 1,
                row_offset: int = 0, tile_h: int = 16) -> TileInputs:
    """Bin the splats into tile_h x tile_x tiles and build K1's attribute
    table and tile origins (``img_height`` rows; a strided band of them with
    ``row_stride``)."""
    n, c = xys.shape[0], colors.shape[-1]
    if c > 4:
        raise ValueError(f"the compositing kernel takes up to 4 channels, got {c}")
    subtiles_per_tile(tile_x, tile_h)
    tiles_x = (img_width + tile_x - 1) // tile_x
    tiles_y = (img_height + tile_h - 1) // tile_h
    bins = bin_splats_dense(
        xys, depths, radii, valid, tiles_x, tiles_y, tile_h, chunk=chunk,
        dup_capacity=dup_capacity, max_per_tile=max_per_tile,
        span_capacity=span_capacity, conics=conics, opacities=opacities,
        tile_size_x=tile_x, row_stride=row_stride, row_offset=row_offset,
    )
    ecol = torch.nn.functional.pad(colors, (0, 4 - c))
    per_splat = torch.cat([xys, conics, opacities.reshape(-1, 1), ecol], dim=1)
    table = torch.cat([per_splat.to(torch.float32)[bins.order.long()],
                       per_splat.new_zeros((1, TABLE_COLS), dtype=torch.float32)])
    tid = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=xys.device)
    sx = (tid % tiles_x) * tile_x
    sy = ((tid // tiles_x) * row_stride + int(row_offset)) * tile_h
    return TileInputs(table.contiguous(), bins.entry_rank, bins.tile_starts,
                      bins.counts, sx, sy, tile_x, tile_h, tiles_x, tiles_y, bins)


def _check_composite_args(table, entry_rank, tile_starts, counts, sx, sy, tile_x,
                          tile_h):
    dev = table.device
    if table.dim() != 2 or table.shape[1] != TABLE_COLS or table.shape[0] < 1:
        raise ValueError(f"table must be (N + 1, {TABLE_COLS}), got {tuple(table.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    nt = tile_starts.shape[0]
    for name, x in (("entry_rank", entry_rank), ("tile_starts", tile_starts),
                    ("counts", counts), ("sx", sx), ("sy", sy)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got {x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, table on {dev}")
        if name != "entry_rank" and x.shape[0] != nt:
            raise ValueError(f"{name} has {x.shape[0]} tiles, tile_starts {nt}")
    subtiles_per_tile(tile_x, tile_h)


def subtile_grid(tile_x: int, tile_h: int = 16) -> tuple:
    """(rows, columns) of the SUB_H x SUB_X sub-tile blocks K1 and K2 cut a
    tile_h x tile_x tile into, the last row and column ragged where the tile
    is not a multiple of the sub-tile. Raises unless the tile height is
    positive and tile_x a positive multiple of SUB_X or equal to tile_h (a
    square tile of any size)."""
    if tile_h <= 0:
        raise ValueError(f"the tile height must be positive, got {tile_h}")
    if tile_x <= 0 or (tile_x % SUB_X and tile_x != tile_h):
        raise ValueError(f"tile_x must be a positive multiple of the {SUB_X}-pixel "
                         f"sub-tile width, or the tile height, got {tile_x}")
    return -(-tile_h // SUB_H), -(-tile_x // SUB_X)


def subtiles_per_tile(tile_x: int, tile_h: int = 16) -> int:
    """The number of sub-tile blocks of a tile_h x tile_x tile (``subtile_grid``)."""
    rows, cols = subtile_grid(tile_x, tile_h)
    return rows * cols


def subtile_max(x: torch.Tensor, tile_x: int, tile_h: int = 16) -> torch.Tensor:
    """(num_tiles, subtiles) the max of (num_tiles, tile_h * tile_x) per-pixel
    values over each sub-tile's pixels, sub-tiles row by row (``x`` >= 0: the
    ragged sub-tiles' missing pixels count as 0)."""
    rows, cols = subtile_grid(tile_x, tile_h)
    x = x.reshape(-1, tile_h, tile_x)
    if (rows * SUB_H, cols * SUB_X) != (tile_h, tile_x):
        x = torch.nn.functional.pad(x, (0, cols * SUB_X - tile_x, 0, rows * SUB_H - tile_h))
    return x.reshape(-1, rows, SUB_H, cols, SUB_X).amax(dim=(2, 4)).reshape(-1, rows * cols)


def subtile_live(out: torch.Tensor, counts: torch.Tensor, tile_x: int,
                 tile_h: int = 16) -> torch.Tensor:
    """(num_tiles, subtiles) int32: each sub-tile's live prefix in the
    backward, the max last_contrib of its pixels (at most the tile's count).
    No pixel keeps an entry at or past its last_contrib, so the prefix is
    exact."""
    last = subtile_max(out[:, 6], tile_x, tile_h)
    return torch.minimum(last.to(torch.int32), counts[:, None])


def work_order(depth: torch.Tensor) -> torch.Tensor:
    """Sub-tile work items (flat index tile * subtiles + sub), deepest first:
    the int32 order that sorts ``depth`` descending, ties in index order.
    Computed on the device; the kernels' block b takes item order[b]."""
    return torch.argsort(depth.reshape(-1), descending=True, stable=True).to(torch.int32)


def composite_fwd(table, entry_rank, tile_starts, counts, sx, sy, tile_x: int,
                  tile_h: int = 16) -> torch.Tensor:
    """Composite every tile's entries front to back: (num_tiles, 8,
    tile_h * tile_x).

    Launches K1 on CUDA tensors (``_build.launches["composite_fwd"]``
    counts the launches) and runs ``composite_fwd_plain`` on CPU tensors.
    """
    _check_composite_args(table, entry_rank, tile_starts, counts, sx, sy, tile_x, tile_h)
    if table.device.type == "cpu":
        return composite_fwd_plain(table, entry_rank, tile_starts, counts, sx, sy, tile_x,
                                   tile_h)
    if table.device.type != "cuda":
        raise ValueError(f"composite_fwd runs on CUDA or CPU tensors, not {table.device}")
    args = [x.contiguous() for x in (table, entry_rank, tile_starts, counts, sx, sy)]
    num_tiles = tile_starts.shape[0]
    out = torch.empty((num_tiles, OUT_ROWS, tile_h * tile_x), dtype=torch.float32,
                      device=table.device)
    order = work_order(args[3][:, None].expand(num_tiles, subtiles_per_tile(tile_x, tile_h)))
    _launch("composite_fwd", table.device, args[0].data_ptr(), args[0].shape[0],
            args[1].data_ptr(), args[1].shape[0], args[2].data_ptr(), args[3].data_ptr(),
            args[4].data_ptr(), args[5].data_ptr(), num_tiles, tile_h, tile_x, SUB_X,
            order.data_ptr(), out.data_ptr())
    return out


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C signature of each kernel's entry point; the CUDA stream comes last.
_SIGNATURES = {
    "composite_fwd": (_P, _I, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "composite_bwd": (_P, _I, _P, _LL, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P,
                      _P, _P),
    "segsum": (_P, _I, _P, _P, _I, _P, _P),
    "scatter_rows": (_P, _P, _LL, _I, _P, _P),
}


def _launch(name: str, device: torch.device, *args) -> None:
    _build.launch(name, _SIGNATURES[name], device, *args)


def composite_fwd_plain(table, entry_rank, tile_starts, counts, sx, sy,
                        tile_x: int, tile_h: int = 16) -> torch.Tensor:
    """K1 in plain PyTorch: the same sequential walk, vectorized over a
    block of tiles x pixels instead of threads.

    Step k composites entry k of every tile in the block, one elementwise op
    per rounding in the kernel's order, so on the card the two agree bit
    for bit. A block stops once none of its pixels is live.
    """
    dev = table.device
    num_tiles = tile_starts.shape[0]
    p = tile_h * tile_x
    out = torch.zeros((num_tiles, OUT_ROWS, p), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return out
    sentinel = table.shape[0] - 1
    n_slots = entry_rank.shape[0]
    pix = torch.arange(p, device=dev)
    lx, ly = pix % tile_x, pix // tile_x
    for t0, t1 in _plain_blocks(num_tiles, p):
        start = tile_starts[t0:t1].long()
        cnt = counts[t0:t1].long()
        px = (sx[t0:t1, None] + lx).to(torch.float32)  # (B, P)
        py = (sy[t0:t1, None] + ly).to(torch.float32)
        T = torch.ones((t1 - t0, p), device=dev)
        acc = torch.zeros((t1 - t0, 4, p), device=dev)
        n_contrib = torch.zeros((t1 - t0, p), dtype=torch.int64, device=dev)
        last = torch.zeros((t1 - t0, p), dtype=torch.int64, device=dev)
        live = torch.ones((t1 - t0, p), dtype=torch.bool, device=dev)
        for k in range(int(cnt.max())):
            if k % _PLAIN_LIVE_CHECK == 0 and not bool(live.any()):
                break
            ok = (k < cnt)[:, None]  # (B, 1)
            slot = torch.clamp(start + k, 0, n_slots - 1)
            r = torch.where(ok[:, 0], entry_rank[slot].long(), -1)
            r = torch.where((r < 0) | (r > sentinel), sentinel, r)
            row = table[r]  # (B, TABLE_COLS)
            dx = px - row[:, 0:1]
            dy = py - row[:, 1:2]
            a, b, c = row[:, 2:3], row[:, 3:4], row[:, 4:5]
            sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
            alpha = torch.clamp(row[:, 5:6] * torch.exp(-sigma), max=ALPHA_MAX)
            kept = live & (sigma >= 0.0) & (alpha >= ALPHA_EPS)
            next_t = T * (1.0 - alpha)
            stop = kept & (next_t <= T_EPS)
            contrib = kept & ~stop
            w = alpha * T
            acc = torch.where(contrib[:, None], acc + w[:, None] * row[:, 6:10, None], acc)
            T = torch.where(contrib, next_t, T)
            last = torch.where(contrib, k + 1, last)
            live = live & ~stop
            n_contrib = torch.where(live & ok, k + 1, n_contrib)
        out[t0:t1, 0:4] = acc
        out[t0:t1, 4] = T
        out[t0:t1, 5] = n_contrib.to(torch.float32)
        out[t0:t1, 6] = last.to(torch.float32)
    return out


def _check_bwd_args(table, entry_rank, tile_starts, counts, sx, sy, out, gout, tile_x,
                    tile_h):
    _check_composite_args(table, entry_rank, tile_starts, counts, sx, sy, tile_x, tile_h)
    shape = (tile_starts.shape[0], OUT_ROWS, tile_h * tile_x)
    for name, x in (("out", out), ("gout", gout)):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")


def composite_bwd(table, entry_rank, tile_starts, counts, sx, sy, out, gout,
                  tile_x: int, tile_h: int = 16) -> torch.Tensor:
    """Per-entry gradient rows (len(entry_rank), 10) of K1's table columns
    [x, y, conic a, b, c, opacity, c0..c3], given K1's output ``out`` and
    its cotangent ``gout`` (rows 0-4 are read: g_c0..g_c3, g_T_final).

    Launches K2 on CUDA tensors (``_build.launches["composite_bwd"]``
    counts the launches) and runs ``composite_bwd_plain`` on CPU tensors.
    Rows past each tile's live prefix are zero.

    K2 runs one block per sub-tile, deepest live prefix first
    (``subtile_live``, ``work_order``); with several sub-tiles a tile's
    blocks write their partial rows into a (subtiles, len(entry_rank), 10)
    scratch buffer and the tile's last block to finish folds them in sub-tile
    order, so two launches on the same inputs give the same bytes.
    """
    _check_bwd_args(table, entry_rank, tile_starts, counts, sx, sy, out, gout, tile_x,
                    tile_h)
    if table.device.type == "cpu":
        return composite_bwd_plain(table, entry_rank, tile_starts, counts, sx, sy, out,
                                   gout, tile_x, tile_h)
    if table.device.type != "cuda":
        raise ValueError(f"composite_bwd runs on CUDA or CPU tensors, not {table.device}")
    args = [x.contiguous() for x in (table, entry_rank, tile_starts, counts, sx, sy, out, gout)]
    num_tiles, n_slots = tile_starts.shape[0], entry_rank.shape[0]
    ns = subtiles_per_tile(tile_x, tile_h)
    grads = torch.zeros((n_slots, TABLE_COLS), dtype=torch.float32, device=table.device)
    live = subtile_live(args[6], args[3], tile_x, tile_h).contiguous()
    order = work_order(live)
    scratch = (torch.empty((ns, n_slots, TABLE_COLS), dtype=torch.float32, device=table.device)
               if ns > 1 else grads)
    tile_done = torch.zeros(num_tiles, dtype=torch.int32, device=table.device)
    _launch("composite_bwd", table.device, args[0].data_ptr(), args[0].shape[0],
            args[1].data_ptr(), n_slots, args[2].data_ptr(), args[4].data_ptr(),
            args[5].data_ptr(), num_tiles, tile_h, tile_x, args[6].data_ptr(),
            args[7].data_ptr(), SUB_X, live.data_ptr(), order.data_ptr(), scratch.data_ptr(),
            tile_done.data_ptr(), grads.data_ptr())
    return grads


def _plain_blocks(num_tiles: int, p: int):
    """The (t0, t1) blocks of tiles the plain walks take at a time."""
    block = max(1, _PLAIN_BLOCK_ELEMS // p)
    return [(t0, min(t0 + block, num_tiles)) for t0 in range(0, num_tiles, block)]


class _BwdBlock(NamedTuple):
    """A block of tiles in the plain backward walk."""

    start: torch.Tensor  # (B,) first slot of each tile
    px: torch.Tensor  # (B, P) pixel centres
    py: torch.Tensor
    n_contrib: torch.Tensor  # (B, P)
    live: torch.Tensor  # (B,) the tile's live prefix


def _bwd_block(out, tile_starts, counts, sx, sy, tile_x: int, tile_h: int, t0: int,
               t1: int) -> _BwdBlock:
    pix = torch.arange(tile_h * tile_x, device=out.device)
    return _BwdBlock(
        tile_starts[t0:t1].long(),
        (sx[t0:t1, None] + pix % tile_x).to(torch.float32),
        (sy[t0:t1, None] + pix // tile_x).to(torch.float32),
        out[t0:t1, 5].long(),
        torch.minimum(out[t0:t1, 6].amax(dim=1).long(), counts[t0:t1].long()))


def _bwd_entry(table, entry_rank, blk: _BwdBlock, k: int):
    """Entry k of every tile of a plain backward block: (ok: the tile's live
    prefix holds it, slots, rows, dx, dy, alpha before and after the clamp,
    kept: the pixels whose composite it entered). One elementwise op per
    rounding, in K1's order, so the masks are K1's and K2's bit for bit."""
    sentinel, n_slots = table.shape[0] - 1, entry_rank.shape[0]
    ok = k < blk.live  # (B,)
    slot = torch.clamp(blk.start + k, 0, n_slots - 1)
    r = torch.where(ok, entry_rank[slot].long(), -1)
    r = torch.where((r < 0) | (r > sentinel), sentinel, r)
    row = table[r]  # (B, TABLE_COLS)
    dx = blk.px - row[:, 0:1]
    dy = blk.py - row[:, 1:2]
    a, b, c = row[:, 2:3], row[:, 3:4], row[:, 4:5]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    raw = row[:, 5:6] * torch.exp(-sigma)
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    kept = (k < blk.n_contrib) & (sigma >= 0.0) & (alpha >= ALPHA_EPS)
    return ok, slot, row, dx, dy, raw, alpha, kept


def composite_bwd_plain(table, entry_rank, tile_starts, counts, sx, sy, out, gout,
                        tile_x: int, tile_h: int = 16) -> torch.Tensor:
    """K2 in plain PyTorch: the same back-to-front walk, vectorized over a
    block of tiles x pixels instead of threads.

    Step k handles entry k of every tile in the block whose live prefix
    (the max of its pixels' last_contrib, at most its count) holds it. Per
    pixel, T and S are one elementwise op per rounding in K2's order (one
    correctly rounded reciprocal r = 1 / (1 - alpha), then T r and alpha r),
    so on the card the two differ only in the order of the pixel sums and
    in K2's fused multiply-adds in the gradient terms.
    """
    num_tiles = tile_starts.shape[0]
    p = tile_h * tile_x
    n_slots = entry_rank.shape[0]
    grads = torch.zeros((n_slots, TABLE_COLS), dtype=torch.float32, device=table.device)
    if num_tiles == 0 or n_slots == 0:
        return grads
    for t0, t1 in _plain_blocks(num_tiles, p):
        blk = _bwd_block(out, tile_starts, counts, sx, sy, tile_x, tile_h, t0, t1)
        T = out[t0:t1, 4].clone()
        g = gout[t0:t1, 0:4]  # (B, 4, P)
        S = gout[t0:t1, 4] * T
        for k in range(int(blk.live.max()) - 1, -1, -1):
            ok, slot, row, dx, dy, raw, alpha, kept = _bwd_entry(table, entry_rank, blk, k)
            a, b, c = row[:, 2:3], row[:, 3:4], row[:, 4:5]
            r = torch.reciprocal(1.0 - alpha)
            t_before = T * r
            w = alpha * t_before
            q = (row[:, 6:7] * g[:, 0] + row[:, 7:8] * g[:, 1] + row[:, 8:9] * g[:, 2]
                 + row[:, 9:10] * g[:, 3])
            qw = q * w
            dsig = torch.where(kept & (raw < ALPHA_MAX), alpha * r * S - qw, 0.0)
            S = torch.where(kept, S + qw, S)
            T = torch.where(kept, t_before, T)
            wk = torch.where(kept, w, 0.0)
            terms = torch.stack([
                -(a * dx + b * dy) * dsig,
                -(b * dx + c * dy) * dsig,
                0.5 * dsig * dx * dx,
                dsig * dx * dy,
                0.5 * dsig * dy * dy,
                dsig,
                g[:, 0] * wk, g[:, 1] * wk, g[:, 2] * wk, g[:, 3] * wk,
            ], dim=1)  # (B, TABLE_COLS, P)
            sums = terms.sum(dim=2)
            sums[:, 5] = -(sums[:, 5] / torch.clamp(row[:, 5], min=1e-30))
            grads[slot[ok]] = sums[ok]
    return grads


def warp_ids(tile_x: int, tile_h: int = 16) -> torch.Tensor:
    """(tile_h * tile_x,) the warp of each pixel of a tile (row-major pixel
    index) as K1 and K2 run them: WARP_FOOTPRINT patches, row by row (a
    ragged tile's last patches hold fewer pixels)."""
    fw, fh = WARP_FOOTPRINT
    pix = torch.arange(tile_h * tile_x)
    lx, ly = pix % tile_x, pix // tile_x
    return (ly // fh) * -(-tile_x // fw) + lx // fw


def subtile_ids(tile_x: int, tile_h: int = 16) -> torch.Tensor:
    """(tile_h * tile_x,) the sub-tile of each pixel of a tile (row-major
    pixel index), sub-tiles row by row (``subtile_grid``)."""
    cols = subtile_grid(tile_x, tile_h)[1]
    pix = torch.arange(tile_h * tile_x)
    return (pix // tile_x // SUB_H) * cols + pix % tile_x // SUB_X


def entry_extent(table: torch.Tensor) -> torch.Tensor:
    """(len(table), 2) float32 half-widths (ex, ey) of each table row's box,
    outside which no pixel passes the alpha test: the box the kernels cull by
    (``csrc/composite_common.cuh``: ``entry_extent``, whose comment gives the
    margins), up to the rounding of its own float ops. -inf: no pixel passes
    (opacity below 1/255 or NaN); +inf: no bound (a conic that is not
    positive definite, or too thin to bound safely)."""
    a, b, c, op = (table[:, k] for k in (2, 3, 4, 5))
    det = a * c - b * b
    trace = a + c
    s2 = 2.0 * (torch.clamp(torch.log(255.0 * op), min=0.0) * 1.1 + 0.1) / det
    ext = torch.stack([torch.sqrt(s2 * c) * 1.01 + 0.5, torch.sqrt(s2 * a) * 1.01 + 0.5], 1)
    bounded = (a > 0) & (c > 0) & (det > 0) & (trace * trace < 1e4 * det)
    ext = torch.where(bounded[:, None], ext, math.inf)
    return torch.where((op >= ALPHA_EPS)[:, None], ext, -math.inf)


def _stats(x: torch.Tensor) -> dict:
    x = x.reshape(-1).to(torch.float64)
    return {"mean": float(x.mean()), "p99": float(torch.quantile(x, 0.99)),
            "max": float(x.max())}


def composite_counts(table, entry_rank, tile_starts, counts, sx, sy, out,
                     tile_x: int, tile_h: int = 16) -> dict:
    """Work counters of one frame's compositing (plain torch; no kernel
    runs): from K1's output ``out`` and the plain backward walk's keep masks.

    pairs:          (entry, pixel) pairs. ``k1`` K1's walk (each pixel up to
                    its stop); ``k2_pixel`` a pixel's own live prefix
                    (min(last_contrib, count): the least any backward walks);
                    ``k2_sub`` the backward walking each sub-tile's live
                    prefix at every pixel of the tile in it; ``k1_box`` /
                    ``k2_box`` the pairs
                    of ``k1`` / ``k2_pixel`` whose pixel lies in the entry's
                    box (``entry_extent``: the only ones the kernels need to
                    evaluate); ``kept`` the pairs the alpha test keeps (K2's
                    expensive ones, all inside the boxes).
    warps:          (entry, warp) pairs of the WARP_FOOTPRINT warps of the
                    sub-tiles that hold a pixel of the tile: ``walked`` (a
                    warp walks its sub-tile's live prefix) and ``kept``
                    (those with at least one kept pixel).
    tile_entries /  entries walked per tile / per sub-tile: ``k1`` the most
    sub_entries:    any of its pixels evaluates, ``k2`` its live prefix;
                    mean, p99 and max of each.
    """
    _check_bwd_args(table, entry_rank, tile_starts, counts, sx, sy, out, out, tile_x,
                    tile_h)
    nt, p = tile_starts.shape[0], tile_h * tile_x
    ns = subtiles_per_tile(tile_x, tile_h)
    cnt = counts.long()[:, None]
    k1_pixel = torch.minimum(out[:, 5].long() + 1, cnt)
    k2_pixel = torch.minimum(out[:, 6].long(), cnt)
    k2_sub = subtile_max(k2_pixel, tile_x, tile_h)
    wid, sid = warp_ids(tile_x, tile_h), subtile_ids(tile_x, tile_h)
    n_warps = int(wid.max()) + 1
    # Per sub-tile: the tile's pixels in it, and the warps that hold one.
    sub_pixels = torch.bincount(sid, minlength=ns).to(out.device)
    sub_warps = torch.bincount(torch.zeros(n_warps, dtype=torch.long).scatter_(0, wid, sid),
                               minlength=ns).to(out.device)
    wid = wid.to(out.device)
    k1_box = k2_box = kept_pairs = kept_warps = 0
    for t0, t1 in _plain_blocks(nt, p):
        # The walk goes to K1's depth, which is at least the live prefix;
        # the keep mask is zero past the live prefix all the same.
        k1_blk, k2_blk = k1_pixel[t0:t1], k2_pixel[t0:t1]
        blk = _bwd_block(out, tile_starts, counts, sx, sy, tile_x, tile_h, t0, t1)._replace(
            live=k1_blk.amax(dim=1))
        for k in range(int(blk.live.max()) if t1 > t0 else 0):
            _, _, row, dx, dy, _, _, kept = _bwd_entry(table, entry_rank, blk, k)
            ext = entry_extent(row)
            inside = ~((dx.abs() > ext[:, 0:1]) | (dy.abs() > ext[:, 1:2]))
            k1_box += int((inside & (k < k1_blk)).sum())
            k2_box += int((inside & (k < k2_blk)).sum())
            kept_pairs += int(kept.sum())
            per_warp = torch.zeros((t1 - t0, n_warps), dtype=torch.int32, device=out.device)
            kept_warps += int((per_warp.index_add_(1, wid, kept.to(torch.int32)) > 0).sum())
    return {
        "pairs": {"k1": int(k1_pixel.sum()), "k1_box": k1_box,
                  "k2_pixel": int(k2_pixel.sum()), "k2_box": k2_box,
                  "k2_sub": int((k2_sub * sub_pixels).sum()), "kept": kept_pairs},
        "warps": {"walked": int((k2_sub * sub_warps).sum()), "kept": kept_warps},
        "tile_entries": {"k1": _stats(k1_pixel.amax(dim=1)), "k2": _stats(k2_pixel.amax(dim=1))},
        "sub_entries": {"k1": _stats(subtile_max(k1_pixel, tile_x, tile_h)),
                        "k2": _stats(k2_sub)},
    }


def segsum(rows: torch.Tensor, perm: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Segment sums through a permutation: out[i] = the sum of rows[perm[p]]
    over p in [bounds[i], bounds[i + 1]), added in increasing p, for (D, 10)
    float32 ``rows``, (D,) int32 ``perm`` and (M + 1,) int32 nondecreasing
    ``bounds`` (clamped to [0, D]; perm entries to [0, D)); returns (M, 10).

    Launches K3 on CUDA tensors (``_build.launches["segsum"]`` counts the
    launches) and runs ``segsum_plain`` on CPU tensors.
    """
    if rows.dim() != 2 or rows.shape[1] != TABLE_COLS or rows.dtype != torch.float32:
        raise TypeError(f"rows must be float32 (D, {TABLE_COLS}), got {rows.dtype} "
                        f"{tuple(rows.shape)}")
    if perm.dtype != torch.int32 or perm.dim() != 1:
        raise TypeError(f"perm must be a 1-D int32 tensor, got {perm.dtype} {tuple(perm.shape)}")
    if perm.shape[0] != rows.shape[0]:
        raise ValueError(f"perm has {perm.shape[0]} entries, rows {rows.shape[0]}")
    if bounds.dtype != torch.int32 or bounds.dim() != 1 or bounds.shape[0] < 1:
        raise TypeError(f"bounds must be a non-empty 1-D int32 tensor, got {bounds.dtype} "
                        f"{tuple(bounds.shape)}")
    for name, x in (("perm", perm), ("bounds", bounds)):
        if x.device != rows.device:
            raise ValueError(f"{name} is on {x.device}, rows on {rows.device}")
    if rows.device.type == "cpu":
        return segsum_plain(rows, perm, bounds)
    if rows.device.type != "cuda":
        raise ValueError(f"segsum runs on CUDA or CPU tensors, not {rows.device}")
    rows, perm, bounds = rows.contiguous(), perm.contiguous(), bounds.contiguous()
    if rows.data_ptr() % 8:
        raise ValueError("rows must start on an 8-byte boundary (K3 reads 8-byte pieces)")
    m = bounds.shape[0] - 1
    out = torch.empty((m, TABLE_COLS), dtype=torch.float32, device=rows.device)
    _launch("segsum", rows.device, rows.data_ptr(), rows.shape[0], perm.data_ptr(),
            bounds.data_ptr(), m, out.data_ptr())
    return out


def segsum_plain(rows: torch.Tensor, perm: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """K3 in plain PyTorch: every segment adds its rows in sorted order,
    step k adding row perm[bounds[i] + k] of every segment i still that
    long, so on the card the two agree bit for bit."""
    n_rows = rows.shape[0]
    b = bounds.long().clamp(0, n_rows)
    lo = b[:-1]
    length = torch.maximum(b[1:], lo) - lo
    acc = rows.new_zeros((lo.shape[0], TABLE_COLS))
    if n_rows == 0 or lo.numel() == 0:
        return acc
    src = perm.long().clamp(0, n_rows - 1)
    for k in range(int(length.max())):
        ok = (k < length)[:, None]
        acc = torch.where(ok, acc + rows[src[torch.clamp(lo + k, max=n_rows - 1)]], acc)
    return acc


def table_grad(rows: torch.Tensor, entry_rank: torch.Tensor, n: int,
               grad_reduce: str = "scatter") -> torch.Tensor:
    """Per-entry gradient rows (D, 10) -> the table's gradient (n + 1, 10):
    row r < n the sum of the rows of every slot whose ``entry_rank`` is r
    (pad slots, rank -1, go nowhere), row n zero (the table's sentinel).

    ``grad_reduce`` keeps the JAX package's four names:
      'scatter' — ``scatter_rows``: atomic adds in no fixed order on the
                  card, ``index_add_`` in slot order on the CPU; it writes
                  the zero row itself;
      'sorted'  — a stable sort by rank, then ``index_add_`` in sorted order;
      'segment' — the sort, a gather, a cumulative sum and boundary
                  differences (the cumulative sum runs in float64: in float32
                  its rounding grows with the running total, not with the
                  segment);
      'mxu'     — the sort and the segment-sum kernel K3 (``segsum``), which
                  gathers the rows through the sort's permutation itself; the
                  name is the JAX package's, whose kernel put the sums on the
                  TPU's matrix unit.
    The last three append the zero row to their (n, 10) sums.
    """
    if grad_reduce not in GRAD_REDUCE:
        raise ValueError(f"grad_reduce must be one of {GRAD_REDUCE}, got {grad_reduce!r}")
    if grad_reduce == "scatter":
        return scatter_rows(rows, entry_rank, n)
    if grad_reduce == "sorted":
        sorted_ids, perm = torch.sort(_splat_ids(entry_rank, n), stable=True)
        per_splat = rows.new_zeros((n + 1, TABLE_COLS)).index_add_(0, sorted_ids,
                                                                   rows[perm])[:n]
    else:
        perm, bounds = segsum_inputs(entry_rank, n)
        if grad_reduce == "segment":
            csum = torch.cat([rows.new_zeros((1, TABLE_COLS), dtype=torch.float64),
                              torch.cumsum(rows[perm].double(), dim=0)])
            b = bounds.long()
            per_splat = (csum[b[1:]] - csum[b[:-1]]).float()
        else:
            per_splat = segsum(rows, perm, bounds)
    return torch.cat([per_splat, rows.new_zeros((1, TABLE_COLS))])


def reduce_entry_grads(rows: torch.Tensor, entry_rank: torch.Tensor, n: int,
                       grad_reduce: str = "scatter") -> torch.Tensor:
    """Per-entry gradient rows (D, 10) -> per-splat rows (n, 10):
    ``table_grad`` without its zero sentinel row."""
    return table_grad(rows, entry_rank, n, grad_reduce)[:n]


def scatter_rows(rows: torch.Tensor, entry_rank: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1, 10): row r < n the sum of the (D, 10) float32 ``rows`` of the
    slots whose (D,) int32 ``entry_rank`` is r, row n zero (the table's
    sentinel); slots ranked below 0 or at n or above add nothing.

    Launches ``csrc/scatter_rows.cu`` on CUDA tensors
    (``_build.launches["scatter_rows"]`` counts the launches), whose atomic
    adds come in another order each launch, and runs ``scatter_rows_plain``
    on CPU tensors. Raises on any other device, dtype, shape or layout.
    """
    if rows.dim() != 2 or rows.shape[1] != TABLE_COLS or rows.dtype != torch.float32:
        raise TypeError(f"rows must be float32 (D, {TABLE_COLS}), got {rows.dtype} "
                        f"{tuple(rows.shape)}")
    if entry_rank.dtype != torch.int32 or entry_rank.dim() != 1:
        raise TypeError(f"entry_rank must be a 1-D int32 tensor, got {entry_rank.dtype} "
                        f"{tuple(entry_rank.shape)}")
    if entry_rank.shape[0] != rows.shape[0]:
        raise ValueError(f"entry_rank has {entry_rank.shape[0]} slots, rows {rows.shape[0]}")
    if not 0 <= n < 2**31 - 1:
        raise ValueError(f"n must lie in [0, 2**31 - 1), got {n}")
    if entry_rank.device != rows.device:
        raise ValueError(f"entry_rank is on {entry_rank.device}, rows on {rows.device}")
    if rows.device.type == "cpu":
        return scatter_rows_plain(rows, entry_rank, n)
    if rows.device.type != "cuda":
        raise ValueError(f"scatter_rows runs on CUDA or CPU tensors, not {rows.device}")
    if not (rows.is_contiguous() and entry_rank.is_contiguous()):
        raise ValueError("scatter_rows takes contiguous rows and entry_rank")
    if rows.data_ptr() % 8:
        raise ValueError("rows must start on an 8-byte boundary (the kernel reads 8-byte "
                         "pieces)")
    out = torch.zeros((n + 1, TABLE_COLS), dtype=torch.float32, device=rows.device)
    # An operator range of its own, so a trace counts the kernel inside the
    # caller's span (``ts.composite.reduce``, in autograd's backward).
    with op_range("scatter_rows"):
        _launch("scatter_rows", rows.device, rows.data_ptr(), entry_rank.data_ptr(),
                rows.shape[0], n, out.data_ptr())
    return out


def scatter_rows_plain(rows: torch.Tensor, entry_rank: torch.Tensor, n: int) -> torch.Tensor:
    """``scatter_rows`` in plain PyTorch: ``index_add_`` in slot order, the
    pads into row n, which is then zeroed."""
    out = rows.new_zeros((n + 1, TABLE_COLS)).index_add_(0, _splat_ids(entry_rank, n), rows)
    out[n] = 0.0
    return out


def _splat_ids(entry_rank: torch.Tensor, n: int) -> torch.Tensor:
    """Entry ranks as int32 splat ids; pads and out-of-range ranks -> n."""
    ids = entry_rank.to(torch.int32)
    return torch.where((ids < 0) | (ids >= n), n, ids)


def segsum_inputs(entry_rank: torch.Tensor, n: int):
    """K3's inputs: the (D,) int32 stable id-sorted order of the entries and
    the (n + 1,) int32 run bounds of splat ids 0..n-1 in it (the pads' run,
    id n, is left out)."""
    sorted_ids, perm = torch.sort(_splat_ids(entry_rank, n), stable=True)
    bounds = torch.searchsorted(sorted_ids, torch.arange(n + 1, dtype=torch.int32,
                                                         device=entry_rank.device),
                                out_int32=True)
    return perm.to(torch.int32), bounds


class _CompositeTiles(torch.autograd.Function):
    """K1 forward; backward = K2, then ``table_grad``'s ``grad_reduce``
    reduction to the table's rows."""

    @staticmethod
    def forward(ctx, table, entry_rank, tile_starts, counts, sx, sy, tile_x, grad_reduce,
                tile_h=16):
        out = composite_fwd(table, entry_rank, tile_starts, counts, sx, sy, tile_x, tile_h)
        ctx.save_for_backward(table, entry_rank, tile_starts, counts, sx, sy, out)
        ctx.tile_x, ctx.tile_h, ctx.grad_reduce = tile_x, tile_h, grad_reduce
        return out

    @staticmethod
    def backward(ctx, gout):
        table, entry_rank, tile_starts, counts, sx, sy, out = ctx.saved_tensors
        with span("ts.composite.backward"):
            rows = composite_bwd(table, entry_rank, tile_starts, counts, sx, sy, out,
                                 gout.contiguous(), ctx.tile_x, ctx.tile_h)
        with span("ts.composite.reduce"):
            dtable = table_grad(rows, entry_rank, table.shape[0] - 1, ctx.grad_reduce)
        return (dtable,) + (None,) * 8


# composite_tiles(table, entry_rank, tile_starts, counts, sx, sy, tile_x,
# grad_reduce, tile_h=16): ``composite_fwd`` with a gradient for ``table``.
composite_tiles = _CompositeTiles.apply


def untile(out, background, tiles_x: int, tiles_y: int, tile_x: int,
           img_height: int, img_width: int, tile_h: int = 16):
    """K1 output -> (H, W, C) image blended over ``background`` (C,) by
    T_final, and (H, W) alpha = 1 - T_final, cropped to the image."""
    c = background.shape[0]
    t_final = out[:, 4, :]
    bg4 = torch.nn.functional.pad(background, (0, 4 - c))
    img4 = out[:, 0:4, :] + t_final[:, None, :] * bg4[None, :, None]
    img = img4.reshape(tiles_y, tiles_x, 4, tile_h, tile_x).permute(0, 3, 1, 4, 2)
    img = img.reshape(tiles_y * tile_h, tiles_x * tile_x, 4)
    alpha = (1.0 - t_final).reshape(tiles_y, tiles_x, tile_h, tile_x).permute(0, 2, 1, 3)
    alpha = alpha.reshape(tiles_y * tile_h, tiles_x * tile_x)
    return img[:img_height, :img_width, :c], alpha[:img_height, :img_width]


def rasterize_cuda(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    valid: torch.Tensor,
    img_height: int,
    img_width: int,
    background: torch.Tensor,
    chunk: int = 128,
    dup_capacity: int = 0,
    max_per_tile: int = 0,
    span_capacity: int = 0,
    grad_reduce: str = "scatter",
    tiles_per_block: int = 8,
    row_stride: int = 1,
    row_offset=0,
    return_diagnostics: bool = False,
    tile_size: int = 16,
    tile_x: int = 0,
):
    """Rasterize to an (H, W, C<=4) image + (H, W) alpha; dense-oracle
    semantics. Drop-in for ``rasterize_pallas``: with return_diagnostics,
    also returns {'intersections', 'dup_dropped', 'tile_dropped'}, 0-d int32
    tensors on the image's device (the JAX package's device scalars).

    ``tile_size`` sets the tile HEIGHT and ``tile_x`` the WIDTH: 0 (the
    default) makes the tile square, ``tile_size`` x ``tile_size`` at any
    size, as the JAX ``tiled`` backend cuts them; otherwise a positive
    multiple of 16.
    ``chunk`` rounds the binning capacities and sizes the trailing pad, as
    in the JAX layout. ``grad_reduce`` selects the per-entry -> per-splat
    gradient reduction of the backward (``table_grad``).
    ``tiles_per_block`` is a TPU grid-step setting that this path does not
    read. ``row_stride`` / ``row_offset``: render only the global tile rows
    {o, o + S, ...} (``xys`` in global pixels) into an (img_height, W) band.
    """
    if grad_reduce not in GRAD_REDUCE:
        raise ValueError(f"grad_reduce must be one of {GRAD_REDUCE}, got {grad_reduce!r}")
    if tile_size <= 0:
        raise ValueError(f"tile_size must be positive, got {tile_size}")
    if tile_x and (tile_x < 0 or tile_x % SUB_X):
        raise ValueError(f"tile_x must be 0 (square tiles) or a positive multiple of "
                         f"{SUB_X}, got {tile_x}")
    tile_x = tile_x or tile_size
    with span("ts.render.tile_inputs"):
        ti = tile_inputs(xys, depths, radii, conics, colors, opacities, valid,
                         img_height, img_width, chunk=chunk, dup_capacity=dup_capacity,
                         max_per_tile=max_per_tile, span_capacity=span_capacity,
                         tile_x=tile_x, row_stride=row_stride, row_offset=row_offset,
                         tile_h=tile_size)
    with span("ts.render.composite"):
        out = composite_tiles(ti.table, ti.entry_rank, ti.tile_starts, ti.counts,
                              ti.sx, ti.sy, tile_x, grad_reduce, tile_size)
    with span("ts.render.untile"):
        img, alpha = untile(out, background, ti.tiles_x, ti.tiles_y, tile_x,
                            img_height, img_width, tile_size)
    if return_diagnostics:
        diag = {
            "intersections": ti.bins.total_intersections,
            "dup_dropped": ti.bins.dup_overflow,
            "tile_dropped": ti.bins.tile_overflow,
        }
        return img, alpha, diag
    return img, alpha
