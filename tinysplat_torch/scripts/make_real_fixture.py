"""Write a real-photo COLMAP capture (the one committed at
tests/fixtures/real_colmap, or a denser one elsewhere).

    python -m tinysplat_torch.scripts.make_real_fixture   # regenerates the fixture

Port of the JAX package's ``scripts/make_real_fixture.py``; the files it
writes are byte-identical to that script's. The only real photograph in
an offline install is matplotlib's bundled ``grace_hopper.jpg`` (an
official U.S. Navy portrait, public domain). Three crops of it are
texture-mapped onto three planes at three depths and rendered from orbiting
OPENCV-model cameras, so every observed pixel comes from a real photograph
and the multi-view geometry is exact: each view samples the planes through
the full nonlinear camera model, including the radial / tangential
distortion the loader must undo. Outputs:

  <out_root>/images/view_00.jpg ...   (JPEG, quality 92)
  <out_root>/sparse/0/{cameras,images,points3D}.bin

Camera model: OPENCV (fx fy cx cy k1 k2 p1 p2) with mild distortion
(k1=-0.08, k2=0.01, p1=0.001, p2=-0.0005), enough to displace corners by
several pixels. points3D are samples on the planes with texture colours.
Needs matplotlib (the photograph), PIL and cv2; a missing one raises
ImportError.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..data.colmap import (
    ColmapCamera,
    ColmapImage,
    ColmapPoints,
    write_cameras_binary,
    write_images_binary,
    write_points3d_binary,
)

W, H = 240, 180
FX = FY = 260.0
DIST = np.array([-0.08, 0.01, 0.001, -0.0005], np.float64)  # k1 k2 p1 p2
N_VIEWS = 8
SEED = 7  # the sparse points' draws


@dataclass(frozen=True)
class Rig:
    """Image size, intrinsics and orbit size of one capture."""

    width: int = W
    height: int = H
    fx: float = FX
    fy: float = FY
    n_views: int = N_VIEWS

    @property
    def cx(self) -> float:
        return self.width / 2.0

    @property
    def cy(self) -> float:
        return self.height / 2.0


def _textures():
    import matplotlib
    from PIL import Image

    path = os.path.join(matplotlib.get_data_path(), "sample_data", "grace_hopper.jpg")
    img = np.asarray(Image.open(path).convert("RGB"), np.float64) / 255.0
    h, w = img.shape[:2]  # 600 x 512
    return [
        img[0: h // 2, 0: w // 2],          # face (top-left)
        img[h // 3: 5 * h // 6, w // 3:],   # uniform + flag
        img[h // 2:, 0: 2 * w // 3],        # lower half
    ]


def _planes():
    """(origin, U, V, texture) per plane; points are origin + u U + v V,
    u, v in [0, 1]. Three depths / orientations around the origin."""
    texs = _textures()

    def unit(v):
        return np.asarray(v, np.float64) / np.linalg.norm(v)

    # Frontal portrait, slightly tilted back.
    p0 = (np.array([-0.9, -0.9, 0.25]), np.array([1.8, 0.0, 0.0]),
          1.8 * unit([0.0, 1.0, 0.15]), texs[0])
    # Left wall, angled toward the cameras.
    p1 = (np.array([-1.9, -0.8, -1.3]), 1.6 * unit([0.35, 0.0, 1.0]),
          np.array([0.0, 1.6, 0.0]), texs[1])
    # Ground plane in front.
    p2 = (np.array([-0.8, 1.0, -1.5]), np.array([2.0, 0.0, 0.0]),
          2.0 * unit([0.0, 0.35, 1.0]), texs[2])
    return [p0, p1, p2]


def _orbit_pose(i, n_views):
    """World->cam (R, t) for camera i orbiting the origin, +y down world."""
    ang = 2.0 * np.pi * i / n_views
    radius = 4.2
    center = np.array([radius * np.sin(ang) * 0.55,
                       -0.9 + 0.35 * np.sin(2.1 * ang),
                       -radius * np.cos(ang) * 0.28 - 3.2])
    target = np.array([0.0, 0.0, -0.6])
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])  # +y down in image space
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=0)  # world->cam rows
    t = -R @ center
    return R, t


def _distort(xn, yn):
    """The OPENCV forward distortion model on normalized coordinates."""
    k1, k2, p1, p2 = DIST
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def _undistort_grid(rig: Rig):
    """Per-pixel IDEAL normalized coordinates of each DISTORTED pixel
    (fixed-point inversion of the forward model, as OpenCV does)."""
    xs = (np.arange(rig.width) + 0.0 - rig.cx) / rig.fx
    ys = (np.arange(rig.height) + 0.0 - rig.cy) / rig.fy
    xd, yd = np.meshgrid(xs, ys)
    xn, yn = xd.copy(), yd.copy()
    for _ in range(12):
        xe, ye = _distort(xn, yn)
        xn += xd - xe
        yn += yd - ye
    return xn, yn


def render_view(R, t, planes, xn, yn):
    """Sample each plane through the exact nonlinear camera; painter's
    compositing back to front by plane-centre depth, over black (a dark
    room: an unfillable bright backdrop would dominate the training loss)."""
    import cv2

    h, w = xn.shape
    img = np.zeros((h, w, 3), np.float64)
    cam_rays = np.stack([xn, yn, np.ones_like(xn)], axis=-1)  # cam coords
    order = []
    for origin, U, V, tex in planes:
        center = origin + 0.5 * U + 0.5 * V
        order.append(float((R @ center + t)[2]))
    for idx in np.argsort(order)[::-1]:  # far to near
        origin, U, V, tex = planes[idx]
        # Ray-plane intersection in camera coords: P = o_c + u U_c + v V_c,
        # ray d: solve [U_c V_c -d] [u v s]^T = -o_c per pixel.
        o_c = R @ origin + t
        d = cam_rays.reshape(-1, 3)
        A = np.empty((d.shape[0], 3, 3))
        A[:, :, 0] = R @ U
        A[:, :, 1] = R @ V
        A[:, :, 2] = -d
        rhs = np.broadcast_to(-o_c, d.shape)
        uvs = np.linalg.solve(A, rhs[..., None])[..., 0]
        u, v, s = (uvs[:, k].reshape(h, w) for k in range(3))
        hit = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (s > 0.1)
        th, tw = tex.shape[:2]
        mx = (u * (tw - 1)).astype(np.float32)
        my = (v * (th - 1)).astype(np.float32)
        samp = cv2.remap(tex.astype(np.float32), mx, my, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REPLICATE)
        img = np.where(hit[..., None], samp, img)
    return np.clip(img, 0.0, 1.0)


def _rot_to_quat(R):
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return np.array([w, x, y, z])


def main(out_root=None, n_views=None, width=None, height=None, per_plane=120):
    """Write the capture. Without arguments: the committed fixture. With
    them, a denser capture elsewhere (``quality_real``): ``width`` keeps the
    field of view (the focal scales with it), ``height`` only sets the
    rows."""
    from PIL import Image

    rig = Rig()
    if width:
        fx = FX * width / W
        rig = Rig(width=width, height=rig.height, fx=fx, fy=fx)
    if height:
        rig = Rig(width=rig.width, height=height, fx=rig.fx, fy=rig.fy)
    if n_views:
        rig = Rig(rig.width, rig.height, rig.fx, rig.fy, n_views)
    rng = np.random.default_rng(SEED)

    root = out_root or os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "fixtures", "real_colmap")
    img_dir = os.path.join(root, "images")
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(sparse, exist_ok=True)

    planes = _planes()
    xn, yn = _undistort_grid(rig)
    cams = {1: ColmapCamera(1, "OPENCV", rig.width, rig.height,
                            np.array([rig.fx, rig.fy, rig.cx, rig.cy, *DIST]))}
    images = {}
    for i in range(rig.n_views):
        R, t = _orbit_pose(i, rig.n_views)
        img = render_view(R, t, planes, xn, yn)
        name = f"view_{i:02d}.jpg"
        Image.fromarray((img * 255.0 + 0.5).astype(np.uint8)).save(
            os.path.join(img_dir, name), quality=92)
        images[i + 1] = ColmapImage(
            image_id=i + 1, qvec=_rot_to_quat(R), tvec=t.copy(), camera_id=1, name=name,
            xys=np.zeros((0, 2)), point3d_ids=np.zeros((0,), np.int64))

    # Sparse points: samples on the planes with texture colours.
    pts, cols = [], []
    for origin, U, V, tex in planes:
        u = rng.uniform(0.03, 0.97, per_plane)
        v = rng.uniform(0.03, 0.97, per_plane)
        pts.append(origin[None] + u[:, None] * U[None] + v[:, None] * V[None])
        th, tw = tex.shape[:2]
        cols.append(tex[(v * (th - 1)).astype(int), (u * (tw - 1)).astype(int)])
    xyz = np.concatenate(pts)
    rgb = (np.concatenate(cols) * 255).astype(np.uint8)
    n = xyz.shape[0]
    points = ColmapPoints(ids=np.arange(1, n + 1, dtype=np.int64), xyz=xyz, rgb=rgb,
                          error=np.full((n,), 0.5))

    write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    write_images_binary(images, os.path.join(sparse, "images.bin"))
    write_points3d_binary(points, os.path.join(sparse, "points3D.bin"))
    total = sum(os.path.getsize(os.path.join(img_dir, f)) for f in os.listdir(img_dir))
    print(f"fixture written: {rig.n_views} views, {n} points, "
          f"{total // 1024} KiB of JPEGs -> {root}")


if __name__ == "__main__":
    main()
