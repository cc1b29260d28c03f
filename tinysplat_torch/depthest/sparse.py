"""Sparse SfM depth maps from COLMAP points visible in a camera.

Semantics of the reference framework's tinysplat/depth.py:73-111: project the camera's
visible 3D points into the image, writing camera-space z and the point's
reprojection error at the rounded pixel location. Returned in COO form
(rows, cols, depth, error) — the alignment step only needs the nonzeros.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def estimate_sparse(camera, pcd) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (rows, cols, z, err) of the sparse depth/error maps."""
    ids = np.asarray(camera.visible_point_ids)
    if ids.size == 0:
        z0 = np.zeros((0,))
        return z0.astype(np.int64), z0.astype(np.int64), z0, z0
    xyz_world, _, errors = pcd.get_points(ids)

    view = np.asarray(camera.view_matrix, np.float64)
    xyz_cam = xyz_world @ view[:3, :3].T + view[:3, 3]
    z = xyz_cam[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        x = xyz_cam[:, 0] / z
        y = xyz_cam[:, 1] / z

    # Principal point: include the camera's offset — the regularizer's
    # dense depth maps are rendered with cx = W/2 + cx_off, and the scale
    # fit pairs this sparse projection with them pixel-by-pixel.
    c_x = camera.width / 2 + getattr(camera, "cx_off", 0.0)
    c_y = camera.height / 2 + getattr(camera, "cy_off", 0.0)
    x_2d = np.round(x * camera.f_x + c_x).astype(np.int64)
    y_2d = np.round(y * camera.f_y + c_y).astype(np.int64)

    keep = (
        (z > 0)
        & (x_2d >= 0) & (x_2d < camera.width)
        & (y_2d >= 0) & (y_2d < camera.height)
    )
    return y_2d[keep], x_2d[keep], z[keep], np.asarray(errors, np.float64)[keep]
