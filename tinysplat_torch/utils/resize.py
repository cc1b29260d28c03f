"""``jax.image.resize`` over the last two axes, in PyTorch.

JAX resizes by ``scale_and_translate`` with half-pixel centres and, when
it shrinks an axis, a kernel widened by the scale (antialiasing). PyTorch's
``F.interpolate`` does the same only with ``antialias=True``: then
"linear" is ``bilinear`` and "cubic" is ``bicubic`` with Keys' a = -0.5
(plain ``bicubic`` uses a = -0.75). "nearest" is used for exact 2x
upsampling only, where both pick source pixel floor(i / 2).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_MODES = {"linear": "bilinear", "cubic": "bicubic", "nearest": "nearest"}


def resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """``x`` (..., H, W) resized to (..., *size) as ``jax.image.resize``
    with ``method`` ("linear", "cubic" or "nearest") would."""
    if method not in _MODES:
        raise ValueError(f"resize method {method!r}: one of {sorted(_MODES)}")
    lead, hw = x.shape[:-2], x.shape[-2:]
    if tuple(hw) == tuple(size):
        return x
    x4 = x.reshape((-1, 1) + tuple(hw))
    if method == "nearest":
        out = F.interpolate(x4, size=tuple(size), mode="nearest")
    else:
        out = F.interpolate(x4, size=tuple(size), mode=_MODES[method], align_corners=False,
                            antialias=True)
    return out.reshape(tuple(lead) + tuple(size))
