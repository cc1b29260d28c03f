"""SSIM (structural similarity) and PSNR in PyTorch.

Torch port of ``tinysplat_tpu.ops.ssim``, with pytorch_msssim's
``SSIM(data_range=1.0, size_average=True, channel=3)`` semantics: an 11-tap
Gaussian window with sigma 1.5, K1 0.01, K2 0.03, *valid* (unpadded)
filtering, the mean over all positions and channels. Images are (H, W, C),
the JAX package's layout.

The separable blur runs as two depthwise ``conv2d`` passes. cuDNN computes
float32 convolutions in TF32 by default (~3 decimal digits), so the blur
turns that off for its own forward and backward calls only, through an
autograd function whose backward is the transposed convolution.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@contextlib.contextmanager
def _cudnn_without_tf32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _Blur(torch.autograd.Function):
    """Valid-mode separable blur of (B, C, H, W) by a (size,) window: a
    vertical then a horizontal depthwise pass, in full float32."""

    @staticmethod
    def forward(ctx, x, window):
        c = x.shape[1]
        wv = window.reshape(1, 1, -1, 1).expand(c, 1, -1, 1).contiguous()
        wh = window.reshape(1, 1, 1, -1).expand(c, 1, 1, -1).contiguous()
        ctx.save_for_backward(wv, wh)
        with _cudnn_without_tf32():
            return F.conv2d(F.conv2d(x, wv, groups=c), wh, groups=c)

    @staticmethod
    def backward(ctx, g):
        wv, wh = ctx.saved_tensors
        c = g.shape[1]
        with _cudnn_without_tf32():
            gx = F.conv_transpose2d(F.conv_transpose2d(g, wh, groups=c), wv, groups=c)
        return gx, None


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
             win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01,
             k2: float = 0.03) -> torch.Tensor:
    """Per-position SSIM map, valid positions only: (H-w+1, W-w+1, C)."""
    return ssim_maps(img1[None], img2[None], data_range, win_size, win_sigma, k1, k2)[0]


def ssim_maps(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
              win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01,
              k2: float = 0.03) -> torch.Tensor:
    """``ssim_map`` of each image of an (N, H, W, C) batch: (N, H', W', C)."""
    x = img1.permute(0, 3, 1, 2)  # (N, C, H, W)
    y = img2.permute(0, 3, 1, 2)
    window = torch.as_tensor(_gaussian_window(win_size, win_sigma), dtype=img1.dtype,
                             device=img1.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    # One blur call over the five stacked maps (channels of one depthwise
    # convolution): x, y, x*x, y*y, x*y.
    stacked = torch.cat([x, y, x * x, y * y, x * y], dim=1)
    blurred = _Blur.apply(stacked, window)
    mu_x, mu_y, e_xx, e_yy, e_xy = blurred.chunk(5, dim=1)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = e_xx - mu_xx
    sigma_yy = e_yy - mu_yy
    sigma_xy = e_xy - mu_xy

    cs_map = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    smap = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return smap.permute(0, 2, 3, 1)  # (N, H', W', C)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM between two (H, W, C) images in [0, data_range]."""
    return ssim_map(img1, img2, data_range, win_size, win_sigma, k1, k2).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio (torchmetrics ``PeakSignalNoiseRatio``
    semantics)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))
