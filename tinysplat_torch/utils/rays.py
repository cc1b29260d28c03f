"""Camera ray helpers (PixelNeRF-style unprojection map).

Torch port of ``tinysplat_tpu.utils.rays``: per-pixel unit ray directions
in the camera frame.
"""
from __future__ import annotations

import torch


def unproj_map(width: int, height: int, fx, fy, cx=None, cy=None,
               device=None) -> torch.Tensor:
    """(H, W, 3) unit camera-frame ray directions, -z forward:
    (-X, -Y, -1) normalized. ``fx`` / ``fy`` may be float32 tensors."""
    if cx is None:
        cx = width * 0.5
    if cy is None:
        cy = height * 0.5
    if device is None:
        device = fx.device if isinstance(fx, torch.Tensor) else "cpu"
    ys = (torch.arange(height, dtype=torch.float32, device=device) - cy) / fy
    xs = (torch.arange(width, dtype=torch.float32, device=device) - cx) / fx
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    unproj = torch.stack((-X, -Y, -torch.ones_like(X)), dim=-1)
    return unproj / torch.linalg.norm(unproj, dim=-1, keepdim=True)
