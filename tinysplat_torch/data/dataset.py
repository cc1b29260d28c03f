"""COLMAP dataset -> cameras + point cloud (host-side; a copy of
``tinysplat_tpu.data.dataset`` over the port's ``Camera`` and ``PointCloud``).

Semantics of the reference framework's loader (its tinysplat/dataset.py:13-114)
on top of the first-party COLMAP parser (data/colmap.py, replacing pycolmap):

- focal/principal-point handling for single- and dual-focal models
  (dataset.py:40-55), including the reference's focal rescale by
  image_size / (2 * principal_point) — which assumes a roughly centered
  principal point — kept for parity;
- OpenCV undistortion when the model carries distortion parameters: pad the
  k-params to 8, getOptimalNewCameraMatrix(alpha=0) + undistort + ROI crop
  (dataset.py:58-75);
- per-image FOV from the (possibly undistorted) dimensions (dataset.py:77-79);
- visible 3D point ids per camera (dataset.py:82);
- spatial extent of the camera rig (dataset.py:99-102) — computed correctly
  here (the reference hstacks positions into one flat vector and takes a
  scalar mean, dataset.py:100; value is unused downstream either way);
- id-sorted PointCloud (dataset.py:104-114).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..cameras import Camera
from ..scene import PointCloud
from .colmap import load_reconstruction

_FISHEYE = {"OPENCV_FISHEYE", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
            "THIN_PRISM_FISHEYE"}


class Dataset:
    """Loads a COLMAP sparse reconstruction + images into Camera objects."""

    def __init__(
        self,
        colmap_path: str,
        images_path: str,
        max_image_dimension: Optional[int] = None,
        lazy_images: bool = True,
    ):
        from PIL import Image

        rec = load_reconstruction(colmap_path)
        self.cameras: List[Camera] = []

        for img in rec.images.values():
            image_path = os.path.join(images_path, img.name)
            image = Image.open(image_path)

            cam = rec.cameras[img.camera_id]
            f_x, f_y = cam.focal
            c_x, c_y = cam.principal_point
            # Reference dataset.py:53-55: rescale focal when the stored
            # principal point disagrees with the actual image dimensions.
            f_x *= image.width / 2 / c_x
            f_y *= image.height / 2 / c_y

            dist = cam.distortion
            if dist.size > 0 and np.any(dist != 0.0):
                import cv2

                cam_matrix = np.array(
                    [[f_x, 0, c_x], [0, f_y, c_y], [0, 0, 1]], np.float64
                )
                if cam.model in _FISHEYE:
                    # OPENCV_FISHEYE carries k1..k4 equidistant coefficients.
                    # (The reference loader raises on every distorted model
                    # beyond the k-param path; dataset.py:58-75.)
                    k4 = np.pad(dist, (0, max(0, 4 - len(dist))))[:4].reshape(4, 1)
                    size = (image.width, image.height)
                    new_cam_matrix = (
                        cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
                            cam_matrix, k4, size, np.eye(3), balance=0.0
                        )
                    )
                    m1, m2 = cv2.fisheye.initUndistortRectifyMap(
                        cam_matrix, k4, np.eye(3), new_cam_matrix, size,
                        cv2.CV_16SC2,
                    )
                    arr = cv2.remap(np.array(image), m1, m2, cv2.INTER_LINEAR,
                                    borderMode=cv2.BORDER_CONSTANT)
                    image = Image.fromarray(arr)
                else:
                    k_params = np.pad(dist, (0, 8 - len(dist)))
                    new_cam_matrix, roi = cv2.getOptimalNewCameraMatrix(
                        cam_matrix, k_params, (image.width, image.height), 0
                    )
                    arr = cv2.undistort(np.array(image), cam_matrix, k_params,
                                        None, new_cam_matrix)
                    x, y, w, h = roi
                    arr = arr[y : y + h, x : x + w]
                    image = Image.fromarray(arr)
                f_x, f_y = new_cam_matrix[0, 0], new_cam_matrix[1, 1]

            width, height = image.width, image.height
            if max_image_dimension and max(width, height) > max_image_dimension:
                scale = max_image_dimension / max(width, height)
                width, height = int(width * scale), int(height * scale)
                image = image.resize((width, height))
                f_x, f_y = f_x * scale, f_y * scale

            fov_x = 2 * np.arctan(width / (2 * f_x))
            fov_y = 2 * np.arctan(height / (2 * f_y))

            visible = img.point3d_ids[img.point3d_ids >= 0]

            if not lazy_images:
                image = np.array(image.convert("RGB"))

            self.cameras.append(
                Camera(
                    position=img.projection_center(),
                    f_x=f_x,
                    f_y=f_y,
                    fov_x=fov_x,
                    fov_y=fov_y,
                    quat=img.qvec,
                    near=0.001,
                    far=1000.0,
                    image=image,
                    visible_point_ids=np.asarray(visible),
                    # Keep the RELATIVE path as the name: COLMAP layouts may
                    # hold left/001.jpg and right/001.jpg — a basename would
                    # collide camera identities and every name-keyed cache
                    # (depth/semantic .npy, pose slots, device image cache).
                    name=img.name,
                )
            )

        positions = np.stack([c.position for c in self.cameras])  # (N, 3)
        center = positions.mean(axis=0)
        self.spatial_extent = float(
            np.max(np.linalg.norm(positions - center, axis=1)) * 1.1
        )

        self.pcd = PointCloud(
            point_ids=rec.points.ids,
            xyz=rec.points.xyz.astype(np.float32),
            colors=rec.points.rgb.astype(np.float32),
            errors=rec.points.error.astype(np.float32),
        )
