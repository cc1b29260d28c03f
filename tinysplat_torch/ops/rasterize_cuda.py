"""Tile rasterizer: binning + the hand-written compositing kernel K1.

Counterpart of ``tinysplat_tpu.ops.rasterize_pallas`` (forward only; the
backward kernels come with the training path). ``rasterize_cuda`` has
``rasterize_pallas``'s signature, outputs and diagnostics:

1. ``tile_inputs``: ``bin_splats_dense`` lays every tile's depth-sorted
   entries out contiguously (entry ids are depth RANKS); the per-splat
   attribute table is permuted by the depth order, so entry ranks index it
   directly, and a zero SENTINEL row follows it (opacity 0 => no
   contribution). Per-tile pixel origins ``sx``/``sy``.
2. ``composite_fwd``: K1 (``csrc/composite_fwd.cu``) on CUDA tensors, its
   plain PyTorch version ``composite_fwd_plain`` on CPU tensors. Output:
   (num_tiles, 8, 16 * tile_x) f32 rows [c0..c3, T_final, n_contrib,
   last_contrib, 0], the JAX kernel's OUT_ROWS layout.
3. ``untile``: background blend by T_final, tiles -> (H, W) image.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .binning import DenseBins, bin_splats_dense
from .rasterize_dense import ALPHA_EPS, ALPHA_MAX, T_EPS

TILE = 16  # tile height in pixels
OUT_ROWS = 8  # [c0..c3, T_final, n_contrib, last_contrib, 0]
TABLE_COLS = 10  # [x, y, conic a, b, c, opacity, c0..c3]
MAX_THREADS = 1024  # K1 runs one thread per pixel: 16 * tile_x <= 1024
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
    tiles_x: int
    tiles_y: int
    bins: DenseBins


def tile_inputs(xys, depths, radii, conics, colors, opacities, valid,
                img_height: int, img_width: int, chunk: int = 128,
                dup_capacity: int = 0, max_per_tile: int = 0,
                span_capacity: int = 0, tile_x: int = TILE) -> TileInputs:
    """Bin the splats and build K1's attribute table and tile origins."""
    n, c = xys.shape[0], colors.shape[-1]
    if c > 4:
        raise ValueError(f"the compositing kernel takes up to 4 channels, got {c}")
    tiles_x = (img_width + tile_x - 1) // tile_x
    tiles_y = (img_height + TILE - 1) // TILE
    bins = bin_splats_dense(
        xys, depths, radii, valid, tiles_x, tiles_y, TILE, chunk=chunk,
        dup_capacity=dup_capacity, max_per_tile=max_per_tile,
        span_capacity=span_capacity, conics=conics, opacities=opacities,
        tile_size_x=tile_x,
    )
    ecol = torch.nn.functional.pad(colors, (0, 4 - c))
    per_splat = torch.cat([xys, conics, opacities.reshape(-1, 1), ecol], dim=1)
    table = torch.cat([per_splat.to(torch.float32)[bins.order.long()],
                       per_splat.new_zeros((1, TABLE_COLS), dtype=torch.float32)])
    tid = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=xys.device)
    sx = (tid % tiles_x) * tile_x
    sy = (tid // tiles_x) * TILE
    return TileInputs(table.contiguous(), bins.entry_rank, bins.tile_starts,
                      bins.counts, sx, sy, tile_x, tiles_x, tiles_y, bins)


def _check_composite_args(table, entry_rank, tile_starts, counts, sx, sy, tile_x):
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
    if tile_x <= 0 or tile_x % 16:
        raise ValueError(f"tile_x must be a positive multiple of 16, got {tile_x}")


def composite_fwd(table, entry_rank, tile_starts, counts, sx, sy, tile_x: int) -> torch.Tensor:
    """Composite every tile's entries front to back: (num_tiles, 8, 16 * tile_x).

    Launches K1 on CUDA tensors (``composite_fwd.launches`` counts the
    launches) and runs ``composite_fwd_plain`` on CPU tensors.
    """
    _check_composite_args(table, entry_rank, tile_starts, counts, sx, sy, tile_x)
    if table.device.type == "cpu":
        return composite_fwd_plain(table, entry_rank, tile_starts, counts, sx, sy, tile_x)
    if table.device.type != "cuda":
        raise ValueError(f"composite_fwd runs on CUDA or CPU tensors, not {table.device}")
    p = TILE * tile_x
    if p > MAX_THREADS:
        raise ValueError(f"K1 runs one thread per pixel: tile_x {tile_x} gives {p} "
                         f"threads, more than {MAX_THREADS}")
    args = [x.contiguous() for x in (table, entry_rank, tile_starts, counts, sx, sy)]
    num_tiles = tile_starts.shape[0]
    out = torch.empty((num_tiles, OUT_ROWS, p), dtype=torch.float32, device=table.device)
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(args[0].data_ptr(), args[0].shape[0], args[1].data_ptr(),
                 args[1].shape[0], args[2].data_ptr(), args[3].data_ptr(),
                 args[4].data_ptr(), args[5].data_ptr(), num_tiles, tile_x,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA error {err}")
    composite_fwd.launches += 1
    return out


composite_fwd.launches = 0


@functools.cache
def _kernel():
    """K1's C entry point with its ctypes signature (built on first use)."""
    fn = _build.load("composite_fwd").composite_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def composite_fwd_plain(table, entry_rank, tile_starts, counts, sx, sy,
                        tile_x: int) -> torch.Tensor:
    """K1 in plain PyTorch: the same sequential walk, vectorized over a
    block of tiles x pixels instead of threads.

    Step k composites entry k of every tile in the block, one elementwise op
    per rounding in the kernel's order, so on the card the two agree bit
    for bit. A block stops once none of its pixels is live.
    """
    dev = table.device
    num_tiles = tile_starts.shape[0]
    p = TILE * tile_x
    out = torch.zeros((num_tiles, OUT_ROWS, p), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return out
    sentinel = table.shape[0] - 1
    n_slots = entry_rank.shape[0]
    pix = torch.arange(p, device=dev)
    lx, ly = pix % tile_x, pix // tile_x
    block = max(1, _PLAIN_BLOCK_ELEMS // p)
    for t0 in range(0, num_tiles, block):
        t1 = min(t0 + block, num_tiles)
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


def untile(out, background, tiles_x: int, tiles_y: int, tile_x: int,
           img_height: int, img_width: int):
    """K1 output -> (H, W, C) image blended over ``background`` (C,) by
    T_final, and (H, W) alpha = 1 - T_final, cropped to the image."""
    c = background.shape[0]
    t_final = out[:, 4, :]
    bg4 = torch.nn.functional.pad(background, (0, 4 - c))
    img4 = out[:, 0:4, :] + t_final[:, None, :] * bg4[None, :, None]
    img = img4.reshape(tiles_y, tiles_x, 4, TILE, tile_x).permute(0, 3, 1, 4, 2)
    img = img.reshape(tiles_y * TILE, tiles_x * tile_x, 4)
    alpha = (1.0 - t_final).reshape(tiles_y, tiles_x, TILE, tile_x).permute(0, 2, 1, 3)
    alpha = alpha.reshape(tiles_y * TILE, tiles_x * tile_x)
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
    tile_size: int = TILE,
    tile_x: int = 0,
):
    """Rasterize to an (H, W, C<=4) image + (H, W) alpha; dense-oracle
    semantics. Drop-in for ``rasterize_pallas``: with return_diagnostics,
    also returns {'intersections', 'dup_dropped', 'tile_dropped'}.

    ``tile_x`` sets the tile WIDTH (default ``tile_size``; height 16).
    ``chunk`` rounds the binning capacities and sizes the trailing pad, as
    in the JAX layout. ``grad_reduce`` names the gradient reduction of the
    training path and ``tiles_per_block`` a TPU grid-step setting: this
    forward path reads neither.
    """
    if tile_size != TILE:
        raise NotImplementedError(
            f"the tile grid is fixed at {TILE}px rows; got tile_size={tile_size}")
    if row_stride != 1:
        raise NotImplementedError(
            "strided tile-row banding (row_stride != 1) belongs to the sharded "
            "trainer and is not ported")
    tile_x = tile_x or tile_size
    if tile_x <= 0 or tile_x % 16:
        raise ValueError(f"tile_x must be a positive multiple of 16, got {tile_x}")
    ti = tile_inputs(xys, depths, radii, conics, colors, opacities, valid,
                     img_height, img_width, chunk=chunk, dup_capacity=dup_capacity,
                     max_per_tile=max_per_tile, span_capacity=span_capacity,
                     tile_x=tile_x)
    out = composite_fwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts,
                        ti.sx, ti.sy, tile_x)
    img, alpha = untile(out, background, ti.tiles_x, ti.tiles_y, tile_x,
                        img_height, img_width)
    if return_diagnostics:
        diag = {
            "intersections": ti.bins.total_intersections,
            "dup_dropped": ti.bins.dup_overflow,
            "tile_dropped": ti.bins.tile_overflow,
        }
        return img, alpha, diag
    return img, alpha
