"""Monocular depth backends.

Same model zoo as the reference (its tinysplat/depth.py:148-228):
ZoeDepth and MiDaS via torch.hub, DepthAnything via the HF transformers
pipeline (the reference's DepthAnything backend is broken — depth.py:172-201
references undefined names). Every backend declares its output `space`
("depth" metric or "disparity") so the estimator picks the right alignment —
fixing the reference's dead disparity branch (depth.py:61).

Hub/HF backends download weights on first use; without network access they
raise a clear error and the `FunctionBackend` (tests, precomputed maps) or
the .npy cache path still work.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


class FunctionBackend:
    """Wraps any `camera -> (H, W) ndarray` callable (tests, custom models)."""

    def __init__(self, fn: Callable, space: str = "depth", name: str = "function"):
        self.fn = fn
        self.space = space
        self.name = name

    def predict(self, camera) -> np.ndarray:
        return np.asarray(self.fn(camera), np.float64)


class ZoeDepthBackend:
    """ZoeDepth ZoeD_N (metric depth); reference depth.py:148-169."""

    name = "zoe"
    space = "depth"

    def __init__(self):
        import torch

        self.torch = torch
        self.model = torch.hub.load("isl-org/ZoeDepth", "ZoeD_N", pretrained=True)
        self.model.eval()

    def predict(self, camera) -> np.ndarray:
        from PIL import Image

        img = camera.get_original_image()
        pil = Image.fromarray((img * 255).astype(np.uint8))
        return np.asarray(self.model.infer_pil(pil), np.float64)


class MidasBackend:
    """MiDaS DPT_Large (disparity space); reference depth.py:204-228."""

    name = "midas"
    space = "disparity"

    def __init__(self):
        import torch

        self.torch = torch
        self.model = torch.hub.load("intel-isl/MiDaS", "DPT_Large")
        self.model.eval()
        transforms = torch.hub.load("intel-isl/MiDaS", "transforms")
        self.transform = transforms.dpt_transform

    def predict(self, camera) -> np.ndarray:
        torch = self.torch
        img = (camera.get_original_image() * 255).astype(np.uint8)
        batch = self.transform(img)
        with torch.no_grad():
            pred = self.model(batch)
            pred = torch.nn.functional.interpolate(
                pred.unsqueeze(1), size=img.shape[:2], mode="bicubic",
                align_corners=False,
            ).squeeze()
        return pred.cpu().numpy().astype(np.float64)


class DepthAnythingBackend:
    """Depth-Anything via HF transformers pipeline (disparity-like relative
    depth). Replaces the reference's broken implementation (depth.py:172-201)."""

    name = "depth_anything"
    space = "disparity"

    def __init__(self, model_id: str = "LiheYoung/depth-anything-large-hf"):
        from transformers import pipeline

        self.pipe = pipeline("depth-estimation", model=model_id)

    def predict(self, camera) -> np.ndarray:
        from PIL import Image

        img = camera.get_original_image()
        pil = Image.fromarray((img * 255).astype(np.uint8))
        out = self.pipe(pil)
        depth = np.asarray(out["predicted_depth"], np.float64)
        if depth.shape != (camera.height, camera.width):
            import cv2

            depth = cv2.resize(depth, (camera.width, camera.height),
                               interpolation=cv2.INTER_CUBIC)
        return depth


class SparseInterpBackend:
    """Dense depth by interpolating the camera's sparse SfM points.

    The classic sparse-to-dense baseline — and the only dense "estimator"
    that needs no network weights, so real-photo training with
    --regularize-depth runs without network access through the SAME
    DepthEstimator/alignment path a hub model would use. Depths are already
    metric (camera-space z), so the downstream match_scale fit is ~identity.

    The point cloud arrives via ``bind_pcd`` (DepthEstimator supplies it —
    the backend protocol's predict() only sees the camera).
    """

    space = "depth"

    def __init__(self):
        self.pcd = None

    def bind_pcd(self, pcd):
        self.pcd = pcd

    def predict(self, camera) -> np.ndarray:
        from .sparse import estimate_sparse

        if self.pcd is None:
            raise ValueError("sparse_interp backend needs bind_pcd(pcd)")
        rows, cols, z, _err = estimate_sparse(camera, self.pcd)
        h, w = camera.height, camera.width
        if z.size < 4:
            return np.full((h, w), float(z.mean()) if z.size else 1.0)
        from scipy.interpolate import griddata

        gy, gx = np.mgrid[0:h, 0:w]
        pts = np.stack([rows, cols], axis=1).astype(np.float64)
        dense = griddata(pts, z, (gy, gx), method="linear")
        holes = ~np.isfinite(dense)
        if holes.any():  # outside the convex hull: nearest fill
            dense[holes] = griddata(pts, z, (gy[holes], gx[holes]),
                                    method="nearest")
        return dense


def load_backend(name_or_backend):
    if not isinstance(name_or_backend, str):
        return name_or_backend
    name = name_or_backend
    if name == "zoe":
        return ZoeDepthBackend()
    if name == "midas":
        return MidasBackend()
    if name == "depth_anything":
        return DepthAnythingBackend()
    if name == "sparse_interp":
        return SparseInterpBackend()
    raise ValueError(f"Unknown depth model type: {name}")
