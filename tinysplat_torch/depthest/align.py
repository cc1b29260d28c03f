"""Dense-to-sparse depth scale alignment.

Semantics of the reference framework's tinysplat/depth.py:113-145: fit (s, t) by
Nelder-Mead minimizing the reprojection-error-weighted L1 between the sparse
SfM depths and the affinely adjusted dense prediction; disparity variant fits
in inverse-depth space.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import minimize


def _fit_affine_l1(target: np.ndarray, source: np.ndarray, err: np.ndarray,
                   x0=(-0.5, 3.0)) -> np.ndarray:
    w = 1.0 / np.maximum(np.asarray(err, np.float64), 1e-8)

    def func(args):
        s, t = args
        return float(np.mean(np.abs(w * (target - (s * source + t)))))

    res = minimize(func, x0=list(x0), method="Nelder-Mead")
    return res.x


def match_scale(dense: np.ndarray, rows, cols, z_sparse, err) -> np.ndarray:
    """Metric-depth alignment: dense' = s * dense + t (depth.py:131-145)."""
    z_dense = dense[rows, cols]
    s, t = _fit_affine_l1(np.asarray(z_sparse, np.float64), z_dense, err)
    return s * dense + t


def match_scale_disparity(disparity: np.ndarray, rows, cols, z_sparse, err) -> np.ndarray:
    """Disparity alignment: dense' = 1 / (s * disparity + t)
    (depth.py:113-129; dead in the reference — see package docstring)."""
    d_dense = disparity[rows, cols]
    inv_sparse = 1.0 / np.maximum(np.asarray(z_sparse, np.float64), 1e-8)
    s, t = _fit_affine_l1(inv_sparse, d_dense, err)
    denom = s * disparity + t
    return 1.0 / np.where(np.abs(denom) < 1e-8, 1e-8, denom)
