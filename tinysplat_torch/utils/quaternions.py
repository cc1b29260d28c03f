"""Quaternion utilities (torch port of ``tinysplat_tpu.utils.quaternions``).

Quaternions are stored as (w, x, y, z), as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def normalize_quat(quats: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    norm = torch.linalg.norm(quats, dim=-1, keepdim=True)
    return quats / torch.clamp(norm, min=eps)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """Convert (..., 4) quaternions (w, x, y, z) to (..., 3, 3) rotation
    matrices; quaternions are normalized internally."""
    q = normalize_quat(quats)
    w, x, y, z = q.unbind(-1)
    rows = (
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)),
        (2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)),
        (2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_to_rotmat_np(quat: np.ndarray) -> np.ndarray:
    """Numpy single-quaternion variant for host-side camera pose math
    (copy of the JAX package's; normalizes, refuses a degenerate quat)."""
    n = float(np.linalg.norm(np.asarray(quat, np.float64)))
    if not np.isfinite(n) or n < 1e-12:
        raise ValueError(f"degenerate quaternion (norm {n})")
    quat = np.asarray(quat, np.float64) / n
    q0, q1, q2, q3 = float(quat[0]), float(quat[1]), float(quat[2]), float(quat[3])
    return np.asarray(
        [
            [1 - 2 * q2**2 - 2 * q3**2, 2 * q1 * q2 - 2 * q3 * q0, 2 * q1 * q3 + 2 * q2 * q0],
            [2 * q1 * q2 + 2 * q3 * q0, 1 - 2 * q1**2 - 2 * q3**2, 2 * q2 * q3 - 2 * q1 * q0],
            [2 * q1 * q3 - 2 * q2 * q0, 2 * q2 * q3 + 2 * q1 * q0, 1 - 2 * q1**2 - 2 * q2**2],
        ]
    )


def random_quats(generator: torch.Generator, n: int, device="cpu",
                 dtype=torch.float32) -> torch.Tensor:
    """Uniformly random unit quaternions, (n, 4), (w, x, y, z) — Marsaglia
    construction. ``generator`` must live on ``device``; its stream differs
    from ``jax.random``'s, so parity tests inject the draw instead."""
    u, v, w = torch.rand((3, n), generator=generator, device=device, dtype=dtype)
    two_pi = 2.0 * math.pi
    return torch.stack(
        [
            torch.sqrt(1.0 - u) * torch.sin(two_pi * v),
            torch.sqrt(1.0 - u) * torch.cos(two_pi * v),
            torch.sqrt(u) * torch.sin(two_pi * w),
            torch.sqrt(u) * torch.cos(two_pi * w),
        ],
        dim=-1,
    )
