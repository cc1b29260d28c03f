"""Blender / NeRF-synthetic / nerfstudio ``transforms.json`` dataset loader
(a copy of ``tinysplat_tpu.data.blender`` over the port's ``Camera``).

Beyond the reference framework (COLMAP only, its tinysplat/dataset.py):
the other de-facto standard scene format for radiance-field work. Handles
both dialects:

- **Blender / NeRF-synthetic**: global ``camera_angle_x``, frames with
  extensionless ``file_path`` (``.png`` appended), RGBA renders composited
  onto a background color, OpenGL camera-to-world ``transform_matrix``.
- **nerfstudio**: explicit ``fl_x/fl_y/cx/cy/w/h`` intrinsics (global or
  per-frame), ``file_path`` with extension. An off-center principal point
  maps to the Camera's pixel-space ``cx_off/cy_off`` (beyond the
  reference, which assumes the image center and only rescales focals,
  dataset.py:53-55). Lens-distortion parameters are NOT modeled — a
  warning fires; undistort the capture first.

``transform_matrix`` is camera-to-world in the OpenGL convention (camera
looks down -Z, Y up); the framework's cameras use the COLMAP/OpenCV
world-to-camera convention (+Z forward, Y down), so poses are converted by
flipping the camera-frame Y/Z axes and inverting.

These scenes ship no SfM points; ``pcd`` is a uniform random cloud in a
cube sized from the camera rig extent (the standard 3DGS random
initialization for synthetic scenes).
"""
from __future__ import annotations

import json
import math
import os
from typing import List, Optional, Sequence

import numpy as np

from ..cameras import Camera
from ..scene import PointCloud

# OpenGL camera axes (x right, y up, z backward) -> OpenCV (x right, y
# down, z forward): flip the camera-frame Y and Z basis vectors.
_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])


def _resolve_image_path(base_dir: str, file_path: str) -> str:
    p = os.path.join(base_dir, file_path)
    if os.path.splitext(p)[1]:
        return p
    for ext in (".png", ".jpg", ".jpeg", ".JPG", ".PNG"):
        if os.path.exists(p + ext):
            return p + ext
    return p + ".png"  # blender default; error surfaces at open time


def _composite_rgba(img: np.ndarray, background: Sequence[float]) -> np.ndarray:
    rgb = img[..., :3].astype(np.float32)
    if img.dtype == np.uint8:
        rgb = rgb / 255.0
    if img.shape[-1] == 4:
        a = img[..., 3:4].astype(np.float32)
        if img.dtype == np.uint8:
            a = a / 255.0
        rgb = rgb * a + np.asarray(background, np.float32) * (1.0 - a)
    return rgb


class BlenderDataset:
    """Loads a ``transforms*.json`` scene into Camera objects + random pcd.

    Args:
      path: the json file, or a directory containing ``transforms_train.json``
        or ``transforms.json``.
      background: RGB in [0, 1] composited under RGBA frames (NeRF-synthetic
        renders have transparent backgrounds; 3DGS convention is white).
      num_init_points: size of the random initialization cloud.
    """

    def __init__(
        self,
        path: str,
        background: Sequence[float] = (1.0, 1.0, 1.0),
        num_init_points: int = 50_000,
        seed: int = 0,
        max_image_dimension: Optional[int] = None,
    ):
        import logging

        from PIL import Image

        log = logging.getLogger(__name__)

        if os.path.isdir(path):
            for cand in ("transforms_train.json", "transforms.json"):
                p = os.path.join(path, cand)
                if os.path.exists(p):
                    path = p
                    break
        base_dir = os.path.dirname(os.path.abspath(path))
        with open(path) as f:
            meta = json.load(f)

        self.cameras: List[Camera] = []
        positions = []
        for frame in meta["frames"]:
            c2w_gl = np.asarray(frame["transform_matrix"], np.float64)
            c2w = c2w_gl @ _GL_TO_CV
            view = np.linalg.inv(c2w)
            position = c2w[:3, 3]

            img_path = _resolve_image_path(base_dir, frame["file_path"])
            pil = Image.open(img_path)
            w = int(frame.get("w", meta.get("w", pil.width)))
            h = int(frame.get("h", meta.get("h", pil.height)))

            def intr(key, fallback=None):
                return frame.get(key, meta.get(key, fallback))

            fl_x = intr("fl_x")
            if fl_x is None:
                fl_x = 0.5 * w / math.tan(0.5 * float(intr("camera_angle_x")))
            fl_y = intr("fl_y")
            if fl_y is None:
                ay = intr("camera_angle_y")
                fl_y = (0.5 * h / math.tan(0.5 * float(ay))) if ay else fl_x
            fov_x = 2.0 * math.atan(w / (2.0 * float(fl_x)))
            fov_y = 2.0 * math.atan(h / (2.0 * float(fl_y)))

            # Off-center principal point (nerfstudio cx/cy): modeled as a
            # pixel offset on the Camera (shifts projected splat centers).
            # Lens-distortion parameters are NOT modeled — undistort with
            # ns-process-data / COLMAP first.
            cx, cy = intr("cx"), intr("cy")
            if frame is meta["frames"][0] and any(
                    k in meta or k in frame for k in ("k1", "k2", "p1", "p2")):
                if any(float(intr(k) or 0.0) for k in ("k1", "k2", "p1", "p2")):
                    log.warning(
                        "transforms.json carries lens-distortion parameters; "
                        "they are ignored — undistort the capture first")

            if max_image_dimension and max(w, h) > max_image_dimension:
                s = max_image_dimension / max(w, h)
                w, h = int(w * s), int(h * s)
                fl_x, fl_y = fl_x * s, fl_y * s  # fov unchanged
                if cx is not None:
                    cx, cy = float(cx) * s, float(cy) * s

            # RGBA needs eager compositing; RGB stays a lazy PIL handle.
            image = pil
            if pil.mode in ("RGBA", "LA", "P"):
                image = _composite_rgba(
                    np.asarray(pil.convert("RGBA")), background)

            self.cameras.append(Camera(
                position=position,
                f_x=float(fl_x), f_y=float(fl_y),
                fov_x=fov_x, fov_y=fov_y,
                view_matrix=view.astype(np.float32),
                image=image, width=w, height=h,
                cx=(float(cx) if cx is not None else None),
                cy=(float(cy) if cy is not None else None),
                name=os.path.splitext(os.path.basename(
                    frame["file_path"]))[0],
            ))
            positions.append(position)

        # Random init cloud in a cube sized from the camera rig (no SfM
        # points exist in this format): standard 3DGS synthetic-scene init.
        pos = np.asarray(positions, np.float64)
        center = pos.mean(axis=0)
        extent = float(np.max(np.linalg.norm(pos - center, axis=1)))
        extent = max(extent, 1e-3)
        rng = np.random.default_rng(seed)
        xyz = center + rng.uniform(-0.5, 0.5, (num_init_points, 3)) * extent
        colors = rng.uniform(0.0, 255.0, (num_init_points, 3))
        errors = np.ones((num_init_points,), np.float64)
        self.pcd = PointCloud(
            np.arange(num_init_points), xyz.astype(np.float64), colors,
            errors)
