"""Plain PyTorch reference of SuGaR's density term, the yardstick the
program's ``regularize_density`` is held to.

Guédon & Lepetit, "SuGaR: Surface-Aligned Gaussian Splatting for Efficient
3D Mesh Reconstruction" (CVPR 2024, arXiv 2311.12775), with the semantics
of maxgillett/tinysplat (``scripts/train.py``, ``model_gaussian.py``),
written here on its own in float32 with TF32 off (``train.full_float32``),
on top of ``render.project`` and ``render.bin_tiles``:

1. Probe points (``sample``): S splats drawn with replacement, each in
   proportion to the product of its three scales exp(s) (``area_weights``;
   the draw itself is the caller's), and each point its splat's mean plus
   R (exp(s) * eps) for a standard normal eps, R the rotation of the
   normalised quaternion (w, x, y, z).
2. Neighbours (``knn``): each point's K = 16 nearest live splat means by
   the exact squared distance, taken in float64 as a sum of squared
   differences, nearest first, equal distances by the lower index; in
   blocks of points.
3. Density (``density``): d(p) = sum over the neighbours of sigmoid(o)
   exp(-q / 2), q = ||diag(exp(-s)) R^T (p - mean)||^2 clamped to
   [0, 1e8], and d capped at 1 (no gradient past the cap).
4. Depth (``render``): the render's fourth channel, each splat's
   camera-space z composited in the same pass and with the same weights as
   its colour, over ``background[0]`` weighted by the final transmittance;
   the colour is clamped to <= 1, the depth is not.
5. Estimate (``estimate``): each point to camera space (its z) and to
   pixels through the projection (x = W/2 ndc_x + W/2 - 1/2, the render's
   pixel centres; the orbit cameras' principal point is the image centre);
   a point counts when z > 0.001 and its pixel lies in [0, W - 1] x
   [0, H - 1]; the depth map sampled bilinearly, clamped at the border;
   sdf = depth - z; beta = the mean over the point's neighbours of each
   one's smallest scale; d_hat = exp(-sdf^2 / (2 beta^2)), beta floored at
   1e-9.
6. The term (``term``): the mean of |d - d_hat| over the points that count.

Departures from the published description, each the program's documented
behaviour:

- the term compares densities, d against d_hat (tinysplat's density mode);
  the paper's regulariser compares the SDF (+-s sqrt(-2 log d)) with the
  depth map's estimate, and its normal term is not part of it;
- beta, the length scale, is the mean over the 16 neighbours of each one's
  smallest scale, and carries gradient into the scales; the paper takes
  the smallest scale of a single Gaussian;
- splats are drawn by the product of their scales, and a probe (points and
  neighbours) is kept for ``interval_densify`` steps, as tinysplat does; d,
  beta and the depth map follow the current parameters every step;
- q is clamped to [0, 1e8] and d capped at 1.

Every product that a float32 program could run in TF32 goes through
``render.mm`` / ``einsum``, so the control (``render.tf32()``) rounds its
operands. The KNN's exact distances have no such product; in the control
they are taken as a float32 program that runs the cross product on the
tensor cores would take them: ||mean||^2 - 2 p.mean^T, the product through
``render.mm`` (the per-point ||p||^2 orders nothing and is left out).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import render as R

K = 16
ZNEAR = 0.001
KNN_BLOCK_ELEMS = 1 << 26  # (point, splat) distances a KNN block holds


def rotation(quats: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations of the (..., 4) quaternions, normalised."""
    return torch.stack(R._rotmat(quats), dim=-1).reshape(quats.shape[:-1] + (3, 3))


def area_weights(p: Dict[str, torch.Tensor], alive: torch.Tensor) -> torch.Tensor:
    """(N,) each splat's weight in the draw: the product of its scales, 0 for
    dead splats."""
    return torch.where(alive, torch.abs(torch.prod(torch.exp(p["scales"]), dim=-1)), 0.0)


@torch.no_grad()
def sample(p: Dict[str, torch.Tensor], idxs: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """(S, 3) probe points: splat ``idxs`` (S,) moved by R (exp(s) * eps)."""
    s = torch.exp(p["scales"][idxs])
    return p["means"][idxs] + R.einsum("sij,sj->si", rotation(p["quats"][idxs]), eps * s)


def _distances(points: torch.Tensor, means: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(B, N) squared distances of a block of points to every mean, +inf at
    dead splats: exact in float64, or the control's TF32 expansion."""
    if R.Precision.tf32:
        m_sq = torch.sum(means * means, dim=-1)
        d = m_sq[None, :] - 2.0 * R.mm(points, means.T)
    else:
        p64, m64 = points.double(), means.double()
        d = (p64[:, None, 0] - m64[None, :, 0]).square_()
        for c in (1, 2):
            d.add_((p64[:, None, c] - m64[None, :, c]).square_())
    return torch.where(alive[None, :], d, math.inf)


@torch.no_grad()
def knn(points: torch.Tensor, means: torch.Tensor, alive: torch.Tensor,
        k: int = K) -> torch.Tensor:
    """(S, k) int64: each point's k nearest live means, nearest first, equal
    distances by the lower index. A row whose k-th and (k+1)-th distances
    tie is redone by a stable sort of the whole row."""
    n = means.shape[0]
    k = min(k, int(alive.sum()))
    kk = min(k + 1, n)
    block = max(1, KNN_BLOCK_ELEMS // max(n, 1))
    out = []
    for i in range(0, points.shape[0], block):
        d = _distances(points[i:i + block], means, alive)
        vals, idx = torch.topk(d, kk, dim=1, largest=False)
        order = torch.argsort(idx, dim=1)  # by index, then stably by value
        vals, idx = vals.gather(1, order), idx.gather(1, order)
        order = torch.argsort(vals, dim=1, stable=True)
        vals, idx = vals.gather(1, order), idx.gather(1, order)[:, :k]
        if kk > k:
            tied = torch.nonzero(vals[:, k - 1] == vals[:, k])[:, 0]
            if tied.numel():
                idx[tied] = torch.sort(d[tied], dim=1, stable=True).indices[:, :k]
        out.append(idx)
    return torch.cat(out) if out else torch.zeros((0, k), dtype=torch.int64,
                                                   device=means.device)


def density(points: torch.Tensor, knn_idx: torch.Tensor,
            p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(S,) step 3's mixture density over each point's neighbours."""
    mu = points[:, None, :] - p["means"][knn_idx]  # (S, K, 3)
    local = R.einsum("skji,skj->ski", rotation(p["quats"][knn_idx]), mu)  # R^T mu
    q = torch.clamp(torch.sum((local * torch.exp(-p["scales"][knn_idx])) ** 2, dim=-1),
                    0.0, 1e8)
    d = torch.sum(torch.sigmoid(p["opacities"][knn_idx, 0]) * torch.exp(-0.5 * q), dim=-1)
    return torch.where(d > 1.0, 1.0, d)


def beta(p: Dict[str, torch.Tensor], knn_idx: torch.Tensor) -> torch.Tensor:
    """(S,) the mean over each point's neighbours of their smallest scale."""
    return torch.amin(torch.exp(p["scales"]), dim=-1)[knn_idx].mean(dim=-1)


def composite4(s: Dict[str, torch.Tensor], t: R.Tiles, height: int, width: int,
               background4: torch.Tensor) -> torch.Tensor:
    """The (H, W, 4) colour and depth over ``background4``, unclamped: the
    compositing of ``render.composite`` on 4 channels."""
    n = s["xys"].shape[0]
    cols = R._padded(s)
    P = t.tile_h * t.tile_w
    ntiles = t.tiles_x * t.tiles_y
    out = s["rgb"].new_zeros((ntiles, P, 4))
    tfin = s["rgb"].new_ones((ntiles, P))
    grad = torch.is_grad_enabled() and any(c.requires_grad for c in cols)
    parts_c, parts_t, parts_i = [], [], []
    for tiles, k in R._blocks(t, P):
        ids, px, py = R._block_geometry(t, tiles, k, n)
        if grad:
            c, tf = checkpoint(R._composite_block, ids, px, py, *cols, use_reentrant=False)
        else:
            c, tf = R._composite_block(ids, px, py, *cols)
        parts_c.append(c)
        parts_t.append(tf)
        parts_i.append(tiles)
    if parts_i:
        idx = torch.cat(parts_i)
        out = out.index_copy(0, idx, torch.cat(parts_c))
        tfin = tfin.index_copy(0, idx, torch.cat(parts_t))
    img = out + tfin[..., None] * background4
    img = img.reshape(t.tiles_y, t.tiles_x, t.tile_h, t.tile_w, 4).permute(0, 2, 1, 3, 4)
    return img.reshape(t.tiles_y * t.tile_h, t.tiles_x * t.tile_w, 4)[:height, :width]


def render(p: Dict[str, torch.Tensor], cam: R.Camera, background: torch.Tensor,
           tile_h: int, tile_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb (H, W, 3) clamped to <= 1, depth (H, W)) of step 4."""
    s = R.project(p, cam)
    t = R.bin_tiles(s, cam.height, cam.width, tile_h, tile_w)
    s4 = dict(s, rgb=torch.cat([s["rgb"], s["depths"][:, None]], dim=-1))
    bg4 = torch.cat([background, background[:1]]).to(s["xys"].device)
    img4 = composite4(s4, t, cam.height, cam.width, bg4)
    return torch.minimum(img4[..., :3], img4.new_ones(())), img4[..., 3]


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(H, W) ``img`` at pixel coordinates, bilinear, clamped at the border."""
    h, w = img.shape
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = torch.clamp(x0 + 1.0, max=w - 1.0), torch.clamp(y0 + 1.0, max=h - 1.0)
    fx, fy = x - x0, y - y0
    i0, j0, i1, j1 = x0.long(), y0.long(), x1.long(), y1.long()
    return ((img[j0, i0] * (1 - fx) + img[j0, i1] * fx) * (1 - fy)
            + (img[j1, i0] * (1 - fx) + img[j1, i1] * fx) * fy)


def estimate(points: torch.Tensor, depth: torch.Tensor, cam: R.Camera,
             b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_hat (S,), the points that count (S,) bool) of step 5."""
    pc = R.mm(points, cam.view[:3, :3].T) + cam.view[:3, 3]
    z = pc[:, 2]
    hom = R.mm(torch.cat([pc, torch.ones_like(z)[:, None]], dim=-1), cam.proj.T)
    w = hom[:, 3:4]
    ndc = hom[:, :2] / torch.clamp(torch.abs(w), min=1e-9) * torch.sign(w)
    px = 0.5 * cam.width * ndc[:, 0] + cam.width / 2.0 - 0.5
    py = 0.5 * cam.height * ndc[:, 1] + cam.height / 2.0 - 0.5
    counts = ((z > ZNEAR) & (px >= 0) & (px <= cam.width - 1)
              & (py >= 0) & (py <= cam.height - 1))
    sdf = bilinear(depth, px, py) - z
    return torch.exp(-0.5 * sdf ** 2 / torch.clamp(b, min=1e-9) ** 2), counts


def term(points: torch.Tensor, knn_idx: torch.Tensor, p: Dict[str, torch.Tensor],
         depth: torch.Tensor, cam: R.Camera) -> torch.Tensor:
    """Step 6: the mean of |d - d_hat| over the points that count."""
    d = density(points, knn_idx, p)
    d_hat, counts = estimate(points, depth, cam, beta(p, knn_idx))
    err = torch.where(counts, torch.abs(d - d_hat), 0.0)
    return err.sum() / torch.clamp(counts.sum(), min=1).to(err.dtype)
