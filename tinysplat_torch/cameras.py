"""Pinhole camera model: host-side ``Camera`` + a dataclass of tensors.

Torch port of ``tinysplat_tpu.cameras``:

- ``Camera`` is the host object holding pose, intrinsics and the (lazily
  decoded) ground-truth image, with numpy state exactly as in the JAX
  package, so matrices built by either package are equal bit for bit.
- ``CameraParams`` holds the tensors that ``render`` consumes, with the JAX
  package's field names; ``Camera.params(device=...)`` builds it.
- ``so3_exp`` / ``apply_pose_delta`` refine a view by a learnable SE(3)
  delta (``pose_opt``).
- ``Camera.project_points`` / ``backproject_points`` map world points to
  screen coordinates and back (mesh extraction backprojects rendered
  depth), on the device of the points they are given.

Matrix conventions (view matrix from quaternion + position, the OpenGL-ish
projection with +z forward and w = z) are those of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.quaternions import quat_to_rotmat_np


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Camera tensors consumed by ``render`` (all on one device)."""

    viewmat: torch.Tensor  # (4, 4) world -> camera
    projmat: torch.Tensor  # (4, 4) camera -> clip
    cam_pos: torch.Tensor  # (3,) camera center in world coordinates
    fx: torch.Tensor  # () focal length x in pixels
    fy: torch.Tensor  # () focal length y in pixels
    # Principal-point offset from the image center, in pixels at this
    # params' resolution (0 = centered).
    cx_off: torch.Tensor
    cy_off: torch.Tensor

    @property
    def full_projmat(self) -> torch.Tensor:
        return self.projmat @ self.viewmat


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' rotation: (3,) axis-angle -> (3, 3) rotation matrix.

    Differentiable at omega == 0: the 1e-24 under the square root keeps
    theta and the unit axis finite there (the axis is 0 at omega == 0)."""
    theta = torch.sqrt(torch.sum(omega * omega) + 1e-24)
    k = omega / theta
    zero = omega.new_zeros(())
    K = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)


def apply_pose_delta(cam: CameraParams, delta: torch.Tensor) -> CameraParams:
    """Left-multiply the view matrix by an SE(3) delta (pose refinement).

    delta = (omega[3], tau[3]): R' = exp(omega) R, t' = exp(omega) t + tau,
    and cam_pos = -R'^T t'. Differentiable with respect to ``delta``
    through autograd (the gradient path of ``pose_opt``); delta == 0 is the
    identity.
    """
    Rd = so3_exp(delta[:3])
    R2 = Rd @ cam.viewmat[:3, :3]
    t2 = Rd @ cam.viewmat[:3, 3] + delta[3:]
    bottom = torch.zeros((1, 4), dtype=cam.viewmat.dtype, device=cam.viewmat.device)
    bottom[0, 3] = 1.0
    view = torch.cat([torch.cat([R2, t2[:, None]], dim=1), bottom])
    return dataclasses.replace(cam, viewmat=view, cam_pos=-(R2.T @ t2))


def make_view_matrix(position: np.ndarray, quat: np.ndarray) -> np.ndarray:
    """World->camera matrix from camera center + world->cam quaternion."""
    rot = quat_to_rotmat_np(np.asarray(quat, dtype=np.float64))
    view = np.zeros((4, 4), dtype=np.float64)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ np.asarray(position, dtype=np.float64)
    view[3, 3] = 1.0
    return view.astype(np.float32)


def make_proj_matrix(fov_x: float, fov_y: float, znear: float = 0.001, zfar: float = 1000.0) -> np.ndarray:
    """Projection matrix with +z forward and w = z."""
    proj = np.zeros((4, 4), dtype=np.float64)
    proj[0, 0] = 1.0 / np.tan(fov_x / 2)
    proj[1, 1] = 1.0 / np.tan(fov_y / 2)
    proj[2, 2] = (zfar + znear) / (zfar - znear)
    proj[2, 3] = -1.0 * zfar * znear / (zfar - znear)
    proj[3, 2] = 1.0
    return proj.astype(np.float32)


class Camera:
    """Host-side camera: pose, intrinsics, ground-truth image.

    Use :meth:`params` to get the tensors ``render`` consumes.
    """

    _ids = 0

    def __init__(
        self,
        position,
        f_x: float,
        f_y: float,
        fov_x: float,
        fov_y: float,
        quat=None,
        view_matrix: Optional[np.ndarray] = None,
        proj_matrix: Optional[np.ndarray] = None,
        near: float = 0.001,
        far: float = 1000.0,
        visible_point_ids: Optional[np.ndarray] = None,
        image=None,
        width: Optional[int] = None,
        height: Optional[int] = None,
        name: Optional[str] = None,
        cx: Optional[float] = None,
        cy: Optional[float] = None,
    ):
        Camera._ids += 1
        self.id = Camera._ids
        self.position = np.asarray(position, dtype=np.float32)
        self.f_x = float(f_x)
        self.f_y = float(f_y)
        self.fov_x = float(fov_x)
        self.fov_y = float(fov_y)
        self.z_near = float(near)
        self.z_far = float(far)
        self.visible_point_ids = visible_point_ids
        self.name = name
        self.estimated_depth: Optional[np.ndarray] = None

        # Image may be a numpy HxWx3 array (uint8 or float in [0,1]), a PIL
        # image, or None (pose-only camera, e.g. a viewer client camera).
        self._pil_image = None
        self._image = None
        if image is None:
            if width is None or height is None:
                raise ValueError("a camera without an image needs width and height")
            self.width, self.height = int(width), int(height)
        elif isinstance(image, np.ndarray):
            self._image = self._to_float01(image)
            self.height, self.width = self._image.shape[:2]
        else:  # PIL image — decode lazily
            self._pil_image = image
            self.width, self.height = image.width, image.height
        if width is not None:
            self.width = int(width)
        if height is not None:
            self.height = int(height)

        self.cx_off = float(cx) - self.width / 2.0 if cx is not None else 0.0
        self.cy_off = float(cy) - self.height / 2.0 if cy is not None else 0.0

        if view_matrix is not None:
            self.view_matrix = np.asarray(view_matrix, dtype=np.float32)
        else:
            if quat is None:
                raise ValueError("a camera needs a view_matrix or a quat")
            self.update_view_matrix(self.position, quat)
        if proj_matrix is not None:
            self.proj_matrix = np.asarray(proj_matrix, dtype=np.float32)
        else:
            self.update_proj_matrix(self.fov_x, self.fov_y, self.z_near, self.z_far)

    @staticmethod
    def _to_float01(arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        return arr.astype(np.float32)

    def update_view_matrix(self, position, quat) -> None:
        self.position = np.asarray(position, dtype=np.float32)
        self.view_matrix = make_view_matrix(self.position, quat)

    def update_proj_matrix(self, fov_x: float, fov_y: float, znear: float = 0.001, zfar: float = 1000.0) -> None:
        self.fov_x, self.fov_y = float(fov_x), float(fov_y)
        self.proj_matrix = make_proj_matrix(fov_x, fov_y, znear, zfar)

    def rescale(self, factor: float) -> None:
        self.width = int(self.width * factor)
        self.height = int(self.height * factor)
        self.fov_x *= factor
        self.fov_y *= factor
        self.cx_off *= factor  # pixel-space offset scales with resolution
        self.cy_off *= factor
        self.update_proj_matrix(self.fov_x, self.fov_y)

    def params(self, device="cuda") -> CameraParams:
        dev = resolve_device(device)

        def t(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        return CameraParams(
            viewmat=t(self.view_matrix),
            projmat=t(self.proj_matrix),
            cam_pos=t(self.position),
            fx=t(self.f_x),
            fy=t(self.f_y),
            cx_off=t(self.cx_off),
            cy_off=t(self.cy_off),
        )

    @property
    def dims(self) -> Tuple[int, int]:
        return (self.width, self.height)

    def get_original_image(self, dims: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Ground-truth image as float32 HxWx3 in [0, 1], optionally resized
        to (width, height) ``dims``."""
        if self._image is None:
            if self._pil_image is None:
                raise ValueError("Camera has no image")
            self._image = self._to_float01(np.array(self._pil_image.convert("RGB")))
        img = self._image
        if dims is not None and (dims[0] != img.shape[1] or dims[1] != img.shape[0]):
            from PIL import Image

            img = (
                np.array(
                    Image.fromarray((img * 255).astype(np.uint8)).resize(dims)
                ).astype(np.float32)
                / 255.0
            )
        return img

    def get_estimated_depth(self) -> Optional[np.ndarray]:
        return self.estimated_depth

    # -- geometry helpers ------------------------------------------------------

    def _matrices(self, points) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(points, view, proj) as float32 tensors on the points' device."""
        pts = torch.as_tensor(points, dtype=torch.float32)
        view = torch.as_tensor(self.view_matrix, dtype=torch.float32, device=pts.device)
        proj = torch.as_tensor(self.proj_matrix, dtype=torch.float32, device=pts.device)
        return pts, view, proj

    def project_points(self, points, screen_coordinates: bool = True,
                       return_depth: bool = False) -> torch.Tensor:
        """Project (P, 3) world points to (x, y, z) screen (or NDC)
        coordinates, on the points' device. z is NDC depth, or the clip-space
        z with ``return_depth``."""
        points, view, proj = self._matrices(points)
        cam = points @ view[:3, :3].T + view[:3, 3]
        clip = torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1) @ proj.T
        if return_depth:
            out = torch.cat([clip[:, :2] / clip[:, 3:4], clip[:, 2:3]], dim=1)
        else:
            out = (clip / clip[:, 3:4])[:, :3]
        if screen_coordinates:
            c_x = self.width // 2 + self.cx_off
            c_y = self.height // 2 + self.cy_off
            x = 0.5 * self.width * out[:, 0] - 0.5 + c_x
            y = 0.5 * self.height * out[:, 1] - 0.5 + c_y
            out = torch.stack([x, y, out[:, 2]], dim=1)
        return out

    def backproject_points(self, points, scale_depth: bool = True,
                           screen_coordinates: bool = True) -> torch.Tensor:
        """(P, 3) screen points (x, y, camera-z depth) back to world
        coordinates, on the points' device: the depth goes to NDC z through
        the projection matrix, then through the inverse of proj @ view.

        Computed in float64 and returned as float32: with z_near = 0.001,
        NDC z sits within ~1e-3 of 1 and proj @ view has a condition number
        of ~2e4, so float32 (the JAX package's precision) loses ~1e-2 of the
        point at an orbit of radius 3."""
        points = torch.as_tensor(points, dtype=torch.float32).double()
        full_inv = torch.as_tensor(
            np.linalg.inv(self.proj_matrix.astype(np.float64)
                          @ self.view_matrix.astype(np.float64)), device=points.device)
        x, y, z = points[:, 0], points[:, 1], points[:, 2]
        if scale_depth:
            f1, f2 = float(self.proj_matrix[2, 2]), float(self.proj_matrix[2, 3])
            z = (f1 * points[:, 2] + f2) / points[:, 2]
        if screen_coordinates:
            c_x = self.width // 2 + self.cx_off
            c_y = self.height // 2 + self.cy_off
            x = (points[:, 0] + 0.5 - c_x) / self.width * 2
            y = (points[:, 1] + 0.5 - c_y) / self.height * 2
        hom = torch.stack([x, y, z, torch.ones_like(x)], dim=1)
        world = hom @ full_inv.T
        return (world[:, :3] / world[:, 3:4]).float()
