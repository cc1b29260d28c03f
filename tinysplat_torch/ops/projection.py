"""EWA splat projection: 3D Gaussians -> 2D screen-space conics.

Torch port of ``tinysplat_tpu.ops.projection``, with the same arithmetic in
the same order so that the two agree to float32 rounding:

  Sigma_3D = R S S^T R^T from quaternion + (already exponentiated) scales;
  camera transform by viewmat; perspective Jacobian with the camera-space
  x/z and y/z ratios clamped to 1.3 * tan(fov/2); Sigma_2D = J W Sigma W^T
  J^T + 0.3*I low-pass blur; conic = Sigma_2D^{-1}; radius = ceil(3 *
  sqrt(max eigenvalue)); screen xy via the full projection matrix and the
  ndc->pixel mapping; near clip at z = 0.01.

Everything is elementwise over the splat axis; autograd differentiates it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# Low-pass blur added to the projected 2D covariance (gsplat/inria constant).
COV2D_BLUR = 0.3
# Near-plane clip threshold for the projection (gsplat `clip_thresh` default).
CLIP_THRESH = 0.01


class ProjectedGaussians(NamedTuple):
    """Per-splat screen-space quantities (all leading dim N)."""

    xys: torch.Tensor  # (N, 2) pixel-space centers
    depths: torch.Tensor  # (N,) camera-space z
    radii: torch.Tensor  # (N,) int32 3-sigma pixel radius (0 = culled)
    conics: torch.Tensor  # (N, 3) upper-triangular inverse 2D covariance (a, b, c)
    num_tiles_hit: torch.Tensor  # (N,) int32 count of tiles overlapped
    valid: torch.Tensor  # (N,) bool — in front of near plane & invertible cov


def _rotmat_elems(quats: torch.Tensor):
    """The 9 rotation-matrix entries as (N,) tensors (normalized quaternion;
    sqrt(max(q.q, eps)) keeps the gradient finite at a zero quaternion)."""
    q = quats / torch.sqrt(
        torch.clamp(torch.sum(quats * quats, dim=-1, keepdim=True), min=1e-24))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def _cov2d_scalar(means_cam, scales_g, quats, W_rot, fx, fy, tan_fovx, tan_fovy):
    """EWA 2D covariance in (N,) column arithmetic: returns (a, b, c) of the
    symmetric 2x2, blur included."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotmat_elems(quats)
    s0, s1, s2 = scales_g[..., 0], scales_g[..., 1], scales_g[..., 2]
    # M = R diag(s); Sigma = M M^T (6 unique entries).
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    sig00 = m00 * m00 + m01 * m01 + m02 * m02
    sig01 = m00 * m10 + m01 * m11 + m02 * m12
    sig02 = m00 * m20 + m01 * m21 + m02 * m22
    sig11 = m10 * m10 + m11 * m11 + m12 * m12
    sig12 = m10 * m20 + m11 * m21 + m12 * m22
    sig22 = m20 * m20 + m21 * m21 + m22 * m22

    tx, ty, tz = means_cam[..., 0], means_cam[..., 1], means_cam[..., 2]
    tz = torch.where(torch.abs(tz) < 1e-8, 1e-8, tz)
    tx = torch.clamp(tx / tz, -1.3 * tan_fovx, 1.3 * tan_fovx) * tz
    ty = torch.clamp(ty / tz, -1.3 * tan_fovy, 1.3 * tan_fovy) * tz
    rz = 1.0 / tz
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2

    # T = J @ W (J rows have 2 nonzeros).
    w = W_rot
    t00 = j00 * w[0, 0] + j02 * w[2, 0]
    t01 = j00 * w[0, 1] + j02 * w[2, 1]
    t02 = j00 * w[0, 2] + j02 * w[2, 2]
    t10 = j11 * w[1, 0] + j12 * w[2, 0]
    t11 = j11 * w[1, 1] + j12 * w[2, 1]
    t12 = j11 * w[1, 2] + j12 * w[2, 2]

    # u_b = Sigma @ t_b; cov2d_ab = t_a . u_b  (+ low-pass blur on diagonal).
    u00 = sig00 * t00 + sig01 * t01 + sig02 * t02
    u01 = sig01 * t00 + sig11 * t01 + sig12 * t02
    u02 = sig02 * t00 + sig12 * t01 + sig22 * t02
    u10 = sig00 * t10 + sig01 * t11 + sig02 * t12
    u11 = sig01 * t10 + sig11 * t11 + sig12 * t12
    u12 = sig02 * t10 + sig12 * t11 + sig22 * t12

    a = t00 * u00 + t01 * u01 + t02 * u02 + COV2D_BLUR
    b = t00 * u10 + t01 * u11 + t02 * u12
    c = t10 * u10 + t11 * u11 + t12 * u12 + COV2D_BLUR
    return a, b, c


def ndc2pix(ndc: torch.Tensor, size, center) -> torch.Tensor:
    """NDC [-1, 1] -> pixel coordinate; gsplat legacy convention."""
    return 0.5 * size * ndc + center - 0.5


def project_gaussians(
    means: torch.Tensor,
    scales: torch.Tensor,
    glob_scale: float,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    full_projmat: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    img_height: int,
    img_width: int,
    tile_size: int = 16,
    clip_thresh: float = CLIP_THRESH,
) -> ProjectedGaussians:
    """Project N 3D Gaussians to screen space.

    ``scales`` are already exponentiated, ``quats`` need not be normalized,
    ``viewmat`` is (4, 4) or (3, 4) and ``full_projmat`` = projmat @ viewmat.
    """
    dtype, dev = means.dtype, means.device
    fx = torch.as_tensor(fx, dtype=dtype, device=dev)
    fy = torch.as_tensor(fy, dtype=dtype, device=dev)
    tan_fovx = 0.5 * img_width / fx
    tan_fovy = 0.5 * img_height / fy

    W_rot = viewmat[:3, :3]
    t_vec = viewmat[:3, 3]
    means_cam = means @ W_rot.T + t_vec  # (N, 3)
    depths = means_cam[..., 2]
    in_front = depths > clip_thresh

    a, b, c = _cov2d_scalar(
        means_cam, glob_scale * scales, quats, W_rot, fx, fy, tan_fovx, tan_fovy
    )
    det = a * c - b * b
    invertible = det > 0.0
    det_safe = torch.where(invertible, det, 1.0)
    inv_det = 1.0 / det_safe
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    # 3-sigma pixel radius from the larger eigenvalue of cov2d.
    half_trace = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(half_trace * half_trace - det, min=0.1))
    lambda_max = half_trace + disc
    radii_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda_max, min=0.0)))

    # Screen-space centers via full projection.
    ones = torch.ones_like(depths)
    hom = torch.cat([means, ones[..., None]], dim=-1) @ full_projmat.T
    rw = 1.0 / torch.clamp(torch.abs(hom[..., 3]), min=1e-6) * torch.sign(hom[..., 3] + 1e-30)
    xys = torch.stack(
        [
            ndc2pix(hom[..., 0] * rw, float(img_width), torch.as_tensor(cx, dtype=dtype, device=dev)),
            ndc2pix(hom[..., 1] * rw, float(img_height), torch.as_tensor(cy, dtype=dtype, device=dev)),
        ],
        dim=-1,
    )

    valid = in_front & invertible
    radii = torch.where(valid, radii_f, 0.0).to(torch.int32)

    tiles_x = (img_width + tile_size - 1) // tile_size
    tiles_y = (img_height + tile_size - 1) // tile_size
    bx0, bx1, by0, by1 = tile_ranges(xys, radii, tiles_x, tiles_y, tile_size)
    num_tiles_hit = torch.where(valid, (bx1 - bx0) * (by1 - by0), 0).to(torch.int32)

    return ProjectedGaussians(
        xys=xys,
        depths=depths,
        radii=radii,
        conics=conics,
        num_tiles_hit=num_tiles_hit,
        valid=valid,
    )


def tile_ranges(
    xys: torch.Tensor,
    radii: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    tile_size: int = 16,
    tile_size_x: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inclusive-exclusive tile index ranges covered by each splat's AABB.

    ``tile_size`` is the tile HEIGHT; ``tile_size_x`` (default: same) the
    width. Returns int32 (bx0, bx1, by0, by1); culled splats (radius 0)
    cover no tiles.
    """
    tsx = tile_size_x or tile_size
    r = radii.to(xys.dtype)
    x, y = xys[..., 0], xys[..., 1]
    i32 = torch.int32
    # floor (not truncation) so fully off-screen splats clip to empty ranges.
    bx0 = torch.clamp(torch.floor((x - r) / tsx).to(i32), 0, tiles_x)
    bx1 = torch.clamp(torch.floor((x + r) / tsx).to(i32) + 1, 0, tiles_x)
    by0 = torch.clamp(torch.floor((y - r) / tile_size).to(i32), 0, tiles_y)
    by1 = torch.clamp(torch.floor((y + r) / tile_size).to(i32) + 1, 0, tiles_y)
    empty = radii <= 0
    bx1 = torch.where(empty, bx0, bx1)
    by1 = torch.where(empty, by0, by1)
    return bx0, bx1, by0, by1
