"""Synthetic scenes for tests and benchmarks (numpy copy of
``tinysplat_tpu.data.synthetic``: the same numpy draws, bit for bit).

Covers BASELINE.json configs[0] ("1k random Gaussians rasterized to 256x256")
and provides a multi-view toy scene for end-to-end training tests (the
reference has no test assets; SURVEY.md section 4).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..cameras import Camera
from ..scene import PointCloud


def random_gaussian_cloud(
    n: int,
    seed: int = 0,
    extent: float = 1.0,
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    scale_range: Tuple[float, float] = (0.01, 0.08),
):
    """Random splat parameter arrays (means/scales/quats/colors/opacities)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * extent * 0.4 + np.asarray(center, np.float32)
    log_scales = np.log(
        rng.uniform(scale_range[0], scale_range[1], size=(n, 3)).astype(np.float32) * extent
    )
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    colors = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    opac_logits = rng.uniform(-1.0, 3.0, size=(n, 1)).astype(np.float32)
    return means, log_scales, quats, colors, opac_logits


def orbit_cameras(
    num_cameras: int,
    width: int = 128,
    height: int = 128,
    radius: float = 3.0,
    fov: float = 0.9,
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> List[Camera]:
    """Cameras on a horizontal orbit looking at the origin."""
    cams = []
    target = np.asarray(target, np.float64)
    f_x = width / (2 * np.tan(fov / 2))
    f_y = height / (2 * np.tan(fov / 2))
    fov_x = 2 * np.arctan(width / (2 * f_x))
    fov_y = 2 * np.arctan(height / (2 * f_y))
    for i in range(num_cameras):
        theta = 2 * np.pi * i / max(num_cameras, 1)
        pos = target + radius * np.asarray([np.sin(theta), 0.15, np.cos(theta)])
        # Look-at world->cam rotation: rows = camera axes in world coords.
        fwd = target - pos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.asarray([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        cam_up = np.cross(fwd, right)
        rot = np.stack([right, cam_up, fwd], axis=0)
        view = np.zeros((4, 4), np.float64)
        view[:3, :3] = rot
        view[:3, 3] = -rot @ pos
        view[3, 3] = 1.0
        cams.append(
            Camera(
                position=pos,
                f_x=f_x,
                f_y=f_y,
                fov_x=fov_x,
                fov_y=fov_y,
                view_matrix=view.astype(np.float32),
                near=0.001,
                far=1000.0,
                width=width,
                height=height,
                name=f"synthetic_{i:03d}",
            )
        )
    return cams


def synthetic_pcd(n: int = 500, seed: int = 1, extent: float = 1.0) -> PointCloud:
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * extent * 0.4
    colors = rng.uniform(0, 255, size=(n, 3)).astype(np.float32)
    errors = rng.uniform(0.2, 2.0, size=(n,)).astype(np.float32)
    return PointCloud(np.arange(n), xyz, colors, errors)
