"""SSIM (structural similarity) and PSNR in PyTorch.

Torch port of ``tinysplat_tpu.ops.ssim``, with pytorch_msssim's
``SSIM(data_range=1.0, size_average=True, channel=3)`` semantics: an 11-tap
Gaussian window with sigma 1.5, K1 0.01, K2 0.03, *valid* (unpadded)
filtering, the mean over all positions and channels. Images are (H, W, C),
the JAX package's layout.

The map and its backward are ``ssim_cuda``'s: two kernels on CUDA tensors,
their plain versions (the blur as depthwise convolutions in full float32)
on CPU tensors.
"""
from __future__ import annotations

import torch

from ..utils.profiling import span
from .ssim_cuda import fused_ssim_maps, gaussian_window


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
             win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01,
             k2: float = 0.03) -> torch.Tensor:
    """Per-position SSIM map, valid positions only: (H-w+1, W-w+1, C)."""
    # squeeze, not [0]: its backward is a view of the map's gradient, where
    # select's would write a zeroed copy.
    return ssim_maps(img1[None], img2[None], data_range, win_size, win_sigma, k1,
                     k2).squeeze(0)


def ssim_maps(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
              win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01,
              k2: float = 0.03) -> torch.Tensor:
    """``ssim_map`` of each image of an (N, H, W, C) batch: (N, H', W', C)."""
    with span("ts.ssim"):
        return fused_ssim_maps(img1, img2, gaussian_window(win_size, win_sigma),
                               (k1 * data_range) ** 2, (k2 * data_range) ** 2)


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
