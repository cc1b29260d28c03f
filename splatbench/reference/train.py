"""Plain PyTorch training steps: render, L1 + D-SSIM loss, autograd, Adam.

- Loss: (1 - lambda_dssim) mean|rgb - gt| + lambda_dssim (1 - SSIM), SSIM
  with an 11-tap Gaussian window of sigma 1.5, K1 0.01, K2 0.03, valid
  (unpadded) filtering, the mean over positions and channels (Wang et al.
  2004, as pytorch_msssim computes it), in full float32.
- Gradients: autograd through ``render`` (every (entry, pixel) pair of the
  compositing is differentiated, blocks recomputed in the backward).
- Adam (Kingma and Ba): betas (0.9, 0.999), eps 1e-8 outside the square
  root, bias-corrected, one learning rate per leaf.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import render as R

BETAS = (0.9, 0.999)
EPS = 1e-8


@contextlib.contextmanager
def full_float32():
    """cuBLAS and cuDNN in float32, not TF32 (restored on exit)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, 3) images in [0, 1]."""
    x = img.permute(2, 0, 1)[None]
    y = gt.permute(2, 0, 1)[None]
    w = torch.as_tensor(_window(), device=img.device)
    c = 3

    def blur(t):
        t = R.conv(t, w.reshape(1, 1, -1, 1).expand(c, 1, -1, 1).contiguous(), c)
        return R.conv(t, w.reshape(1, 1, 1, -1).expand(c, 1, 1, -1).contiguous(), c)

    mu_x, mu_y = blur(x), blur(y)
    s_xx = blur(x * x) - mu_x * mu_x
    s_yy = blur(y * y) - mu_y * mu_y
    s_xy = blur(x * y) - mu_x * mu_y
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    cs = (2 * s_xy + c2) / (s_xx + s_yy + c2)
    return (((2 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1)) * cs).mean()


def loss_fn(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    l1 = torch.mean(torch.abs(img - gt))
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(img, gt))


class StepRecord(NamedTuple):
    losses: List[float]  # each step's loss
    first_grad: Dict[str, torch.Tensor]  # the first step's gradient by leaf
    params: Dict[str, torch.Tensor]  # the parameters after the last step


def train_steps(params: Dict[str, torch.Tensor], cams: List[R.Camera], gts: List[torch.Tensor],
                backgrounds: List[torch.Tensor], lrs: Dict[str, float], lambda_dssim: float,
                tile_h: int, tile_w: int,
                extra: Optional[Callable[[Dict[str, torch.Tensor], int], torch.Tensor]] = None
                ) -> StepRecord:
    """Steps from ``params`` (leaf name -> tensor; left untouched), one a
    camera, each on its ground truth and background. ``extra(params, i)``,
    where given, is a further term of step i's loss (i from 1), such as an
    objective's regulariser."""
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    with full_float32():
        for i, (cam, gt, bg) in enumerate(zip(cams, gts, backgrounds), start=1):
            img, _ = R.render(p, cam, bg, tile_h, tile_w)
            loss = loss_fn(img, gt, lambda_dssim)
            if extra is not None:
                loss = loss + extra(p, i)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(p, grads)}
            with torch.no_grad():
                for (k, t), g in zip(p.items(), grads):
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    mhat = m[k] / (1 - BETAS[0] ** i)
                    vhat = v2[k] / (1 - BETAS[1] ** i)
                    t.sub_(lrs[k] * mhat / (torch.sqrt(vhat) + EPS))
            del img, loss, grads
    return StepRecord(losses, first, {k: t.detach() for k, t in p.items()})
