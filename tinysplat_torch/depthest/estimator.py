"""DepthEstimator: cache-or-compute per-camera aligned depth maps.

Contract of the reference DepthEstimator (its tinysplat/depth.py:11-65):
on construction, load any cached <name>.npy maps from depths_path;
estimate + cache the rest; set camera.estimated_depth.
"""
from __future__ import annotations

import logging
import os
import numpy as np

from .align import match_scale, match_scale_disparity
from .backends import load_backend
from .sparse import estimate_sparse


def _cache_key(name: str) -> str:
    """Camera name -> flat cache file stem (names are relative paths)."""
    return name.replace("/", "__").replace(os.sep, "__")

log = logging.getLogger(__name__)


class DepthEstimator:
    def __init__(
        self,
        scene,
        pcd=None,
        depths_path: str = "depths",
        model_name="zoe",
        skip_init: bool = False,
        **_unused,
    ):
        self.scene = scene
        self.pcd = pcd
        self.depths_path = depths_path
        self.backend = None
        self._model_name = model_name

        os.makedirs(depths_path, exist_ok=True)
        if skip_init:
            return
        # Cache files key on the SANITIZED camera name (names are relative
        # paths — left/001.jpg and right/001.jpg must not share one file);
        # maps load lazily per camera, not eagerly for the whole directory.
        stored = {f[:-4] for f in os.listdir(depths_path)
                  if f.endswith(".npy")}
        missing = [c for c in scene.cameras
                   if _cache_key(c.name) not in stored]
        if missing:
            self.backend = load_backend(model_name)
        for camera in scene.cameras:
            fname = os.path.join(depths_path, _cache_key(camera.name) + ".npy")
            if _cache_key(camera.name) in stored:
                camera.estimated_depth = np.asarray(
                    np.load(fname, allow_pickle=True), np.float32)
            else:
                depth = self.estimate(camera)
                camera.estimated_depth = depth.astype(np.float32)
                np.save(fname, depth)
                log.debug("estimated depth for %s", camera.name)

    def estimate(self, camera) -> np.ndarray:
        """Dense prediction + SfM scale alignment (depth.py:52-65)."""
        if self.backend is None:
            self.backend = load_backend(self._model_name)
        if hasattr(self.backend, "bind_pcd"):
            self.backend.bind_pcd(self.pcd)  # sparse_interp needs the SfM pts
        dense = self.backend.predict(camera)
        if self.pcd is None or camera.visible_point_ids is None:
            return dense
        rows, cols, z, err = estimate_sparse(camera, self.pcd)
        if z.size < 3:
            return dense
        if getattr(self.backend, "space", "depth") == "disparity":
            return match_scale_disparity(dense, rows, cols, z, err)
        return match_scale(dense, rows, cols, z, err)
