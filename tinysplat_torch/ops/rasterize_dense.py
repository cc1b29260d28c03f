"""Dense reference rasterizer: O(N * pixels) alpha compositing.

Torch port of ``tinysplat_tpu.ops.rasterize_dense``, the numerical oracle
that every tiled rasterizer must match. It evaluates every splat at every
pixel, so it is for tests and tiny scenes only (``rasterizer="dense"``).

Compositing semantics (gsplat legacy forward kernel), per pixel, splats
front-to-back by camera depth:

    sigma = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy        (conic = [a, b, c])
    alpha = min(0.999, opacity * exp(-sigma));  skipped if alpha < 1/255
    composite while transmittance T stays > 1e-4; background blended with
    the residual transmittance.

The sticky early exit ("stop before the first splat whose compositing would
push T <= 1e-4") is exact without a done flag: the inclusive product
t_incl[k] is nonincreasing, so ``t_incl[k] > 1e-4`` is true for every splat
up to the break point and false after it.
"""
from __future__ import annotations

from typing import Tuple

import torch

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4


def sort_by_depth(depths: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Front-to-back splat order; invalid splats last; ties by splat index."""
    key = torch.where(valid, depths, torch.inf)
    return torch.sort(key, stable=True).indices


def alpha_matrix(px, xys, conics, opacities, valid) -> torch.Tensor:
    """Per pixel-splat alpha: (P, S) from (P, 2) pixels and (S,) splat attrs."""
    dx = px[:, 0:1] - xys[None, :, 0]  # (P, S)
    dy = px[:, 1:2] - xys[None, :, 1]
    a, b, c = conics[None, :, 0], conics[None, :, 1], conics[None, :, 2]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp(opacities[None, :] * torch.exp(-sigma), max=ALPHA_MAX)
    keep = (sigma >= 0.0) & (alpha >= ALPHA_EPS) & valid[None, :]
    return torch.where(keep, alpha, 0.0)


def composite(alpha: torch.Tensor, colors: torch.Tensor,
              background: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back compositing of (P, S) depth-ordered alphas with (S, C)
    colors; returns (P, C) image and (P,) final transmittance."""
    ones = alpha.new_ones((alpha.shape[0], 1))
    t_incl = torch.cumprod(1.0 - alpha, dim=1)  # T after compositing splat k
    t_excl = torch.cat([ones, t_incl[:, :-1]], dim=1)
    live = t_incl > T_EPS
    weights = torch.where(live, alpha * t_excl, 0.0)
    out = weights @ colors
    # T after the last composited splat: live is a prefix and t_incl is
    # nonincreasing, so it is the min over live of t_incl (1 if none; the
    # leading ones column also keeps the min defined for zero splats).
    t_final = torch.cat([ones, torch.where(live, t_incl, 1.0)], dim=1).amin(dim=1)
    return out + t_final[:, None] * background[None, :], t_final


def pixel_grid(img_height: int, img_width: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(H*W, 2) pixel coordinates (x, y), row-major (splat centers already
    carry gsplat's -0.5)."""
    ys = torch.arange(img_height, dtype=dtype, device=device)
    xs = torch.arange(img_width, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def rasterize_dense(xys, depths, conics, colors, opacities, valid,
                    img_height: int, img_width: int,
                    background) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize N splats to an (H, W, C) image + (H, W) alpha map
    (opacities already sigmoided; C may carry extra channels, e.g. depth)."""
    order = sort_by_depth(depths, valid)
    px = pixel_grid(img_height, img_width, dtype=xys.dtype, device=xys.device)
    alpha = alpha_matrix(px, xys[order], conics[order],
                         opacities.reshape(-1)[order], valid[order])
    out, t_final = composite(alpha, colors[order], background)
    img = out.reshape(img_height, img_width, -1)
    alpha_img = (1.0 - t_final).reshape(img_height, img_width)
    return img, alpha_img
