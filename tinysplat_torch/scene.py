"""Scene: camera collection + sampling + render dispatch (numpy copy of
``tinysplat_tpu.scene``; its draws are numpy's, so they match bit for bit).

Semantics of the reference framework's tinysplat/scene.py:198-239 with the sampling
off-by-one fixed: the reference reshuffles its camera permutation on every
step except ``step % N == 1`` (scene.py:209 truthiness bug), defeating the
documented 'without replacement' intent. Here each epoch consumes a fresh
permutation exactly once.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .cameras import Camera


class PointCloud:
    """Id-sorted SfM point cloud (reference tinysplat/scene.py:226-239)."""

    def __init__(self, point_ids: np.ndarray, xyz: np.ndarray, colors: np.ndarray, errors: np.ndarray):
        idxs = np.argsort(point_ids)
        self.point_ids = np.asarray(point_ids)[idxs]
        self.xyz = np.asarray(xyz)[idxs]
        self.colors = np.asarray(colors)[idxs]
        self.errors = np.asarray(errors)[idxs]

    def get_points(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        indices = np.searchsorted(self.point_ids, ids)
        # Membership check: searchsorted on an absent id returns an
        # insertion position — either out of bounds (IndexError) or a
        # NEIGHBORING point's row, silently feeding wrong (xyz, error)
        # pairs into the depth scale fit. Fail loudly instead (reference
        # scene.py:234-239 has the silent behavior).
        indices = np.clip(indices, 0, len(self.point_ids) - 1)
        if not np.array_equal(self.point_ids[indices], np.asarray(ids)):
            missing = np.asarray(ids)[self.point_ids[indices] != ids]
            raise KeyError(
                f"{missing.size} point3D id(s) absent from the cloud "
                f"(e.g. {missing[:3].tolist()}) — corrupt/pruned COLMAP "
                f"model")
        return self.xyz[indices], self.colors[indices], self.errors[indices]


class Scene:
    """Holds cameras + a render callable; samples cameras per train step."""

    def __init__(self, cameras: List[Camera], render_fn=None, seed: int = 0):
        self.cameras = cameras
        self.render_fn = render_fn  # callable(camera) -> (rgb, extras)
        self.seed = seed
        self._perm_epoch = -1
        self._perm = np.arange(len(cameras))
        self.current_camera_idx = 0

    def get_random_camera(self, step: int = 0) -> Camera:
        """Camera for `step`: without replacement within an epoch, and a pure
        function of (seed, step) — so training resume from a checkpoint
        replays the exact same camera sequence (the reference's sampler keeps
        hidden cursor state and reshuffles on a buggy condition,
        scene.py:207-216).
        """
        n = len(self.cameras)
        epoch, pos = divmod(step, n)
        if epoch != self._perm_epoch or len(self._perm) != n:
            self._perm = np.random.default_rng(self.seed + epoch).permutation(n)
            self._perm_epoch = epoch
        idx = int(self._perm[pos])
        self.current_camera_idx = idx
        return self.cameras[idx]

    def rescale(self, factor: float) -> None:
        for camera in self.cameras:
            camera.rescale(factor)

    def render(self, camera: Camera, dims: Optional[Tuple[int, int]] = None):
        """Delegates to the bound render callable (scene.py:222-223)."""
        if self.render_fn is None:
            raise RuntimeError("Scene has no render function bound")
        return self.render_fn(camera, dims)
