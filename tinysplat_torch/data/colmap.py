"""Pure-numpy COLMAP reconstruction reader and binary writers (a copy of
``tinysplat_tpu.data.colmap``; the port imports nothing of the JAX package).

The reference framework delegates to the `pycolmap` wheel (its
tinysplat/dataset.py:22); this is a self-contained parser for the three
COLMAP sparse-model files (`cameras`, `images`, `points3D`, `.bin` or
`.txt`) following the format documented at colmap.github.io/format.html,
plus writers of the binary files.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params). Param layouts follow COLMAP's
# src/colmap/sensor/models.h ordering.
CAMERA_MODELS: Dict[int, Tuple[str, int]] = {
    0: ("SIMPLE_PINHOLE", 3),  # f, cx, cy
    1: ("PINHOLE", 4),  # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),  # f, cx, cy, k
    3: ("RADIAL", 5),  # f, cx, cy, k1, k2
    4: ("OPENCV", 8),  # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),  # fx, fy, cx, cy, k1, k2, k3, k4
    6: ("FULL_OPENCV", 12),  # fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6
    7: ("FOV", 5),  # fx, fy, cx, cy, omega
    8: ("SIMPLE_RADIAL_FISHEYE", 4),  # f, cx, cy, k
    9: ("RADIAL_FISHEYE", 5),  # f, cx, cy, k1, k2
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}

# Models whose focal/principal-point live in one (f, cx, cy) triple.
_SINGLE_FOCAL = {"SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # (num_params,) float64

    @property
    def single_focal(self) -> bool:
        return self.model in _SINGLE_FOCAL

    @property
    def focal(self) -> Tuple[float, float]:
        if self.single_focal:
            return float(self.params[0]), float(self.params[0])
        return float(self.params[0]), float(self.params[1])

    @property
    def principal_point(self) -> Tuple[float, float]:
        if self.single_focal:
            return float(self.params[1]), float(self.params[2])
        return float(self.params[2]), float(self.params[3])

    @property
    def num_intrinsics(self) -> int:
        """Focal + principal-point parameter count (rest are distortion)."""
        return 3 if self.single_focal else 4

    @property
    def distortion(self) -> np.ndarray:
        return np.asarray(self.params[self.num_intrinsics :], np.float64)


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) w, x, y, z — world->cam rotation
    tvec: np.ndarray  # (3,) world->cam translation
    camera_id: int
    name: str
    xys: np.ndarray  # (M, 2) 2D keypoints
    point3d_ids: np.ndarray  # (M,) int64; -1 = no 3D point

    def rotmat(self) -> np.ndarray:
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    def projection_center(self) -> np.ndarray:
        """Camera center in world coordinates: -R^T t."""
        return -self.rotmat().T @ self.tvec


@dataclass
class ColmapPoints:
    ids: np.ndarray  # (P,) int64
    xyz: np.ndarray  # (P, 3) float64
    rgb: np.ndarray  # (P, 3) uint8
    error: np.ndarray  # (P,) float64


@dataclass
class Reconstruction:
    cameras: Dict[int, ColmapCamera] = field(default_factory=dict)
    images: Dict[int, ColmapImage] = field(default_factory=dict)
    points: ColmapPoints = None  # type: ignore


def _read(fid, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fid.read(size))


# --- binary readers ----------------------------------------------------------


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.asarray(_read(f, f"<{num_params}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            image_id = _read(f, "<i")[0]
            qvec = np.asarray(_read(f, "<4d"))
            tvec = np.asarray(_read(f, "<3d"))
            (camera_id,) = _read(f, "<i")
            chars = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                if c == b"":  # EOF mid-name: must not spin forever
                    raise ValueError(
                        f"truncated images.bin: EOF inside image name "
                        f"(image_id {image_id})")
                chars += c
            name = chars.decode("utf-8")
            (m,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * m), dtype=np.dtype("<f8,<f8,<i8"))
            xys = np.stack([data["f0"], data["f1"]], axis=-1) if m else np.zeros((0, 2))
            ids = data["f2"].astype(np.int64) if m else np.zeros((0,), np.int64)
            out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, ids)
    return out


def read_points3d_binary(path: str) -> ColmapPoints:
    ids, xyzs, rgbs, errs = [], [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid, x, y, z, r, g, b, err = _read(f, "<Qdddbbbd")
            ids.append(pid)
            xyzs.append((x, y, z))
            rgbs.append((r & 0xFF, g & 0xFF, b & 0xFF))
            errs.append(err)
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return ColmapPoints(
        ids=np.asarray(ids, np.int64),
        xyz=np.asarray(xyzs, np.float64).reshape(-1, 3),
        rgb=np.asarray(rgbs, np.uint8).reshape(-1, 3),
        error=np.asarray(errs, np.float64),
    )


# --- text readers ------------------------------------------------------------


def _text_lines(path: str):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    for line in _text_lines(path):
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        width, height = int(parts[2]), int(parts[3])
        params = np.asarray([float(p) for p in parts[4:]])
        out[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    # Header/observation lines are consumed PAIRWISE over the raw file:
    # COLMAP legitimately writes an EMPTY observations line for images with
    # zero 2D points, and pre-filtering blank lines (as _text_lines does)
    # would desynchronize the pairing for every subsequent image.
    out = {}
    with open(path, "r") as f:
        raw = [ln.rstrip("\n") for ln in f
               if not ln.lstrip().startswith("#")]
    # Leading/trailing blank lines are noise; interior blanks are data.
    while raw and not raw[0].strip():
        raw.pop(0)
    for i in range(0, len(raw), 2):
        parts = raw[i].split()
        if not parts:
            continue
        image_id = int(parts[0])
        qvec = np.asarray([float(x) for x in parts[1:5]])
        tvec = np.asarray([float(x) for x in parts[5:8]])
        camera_id = int(parts[8])
        name = " ".join(parts[9:])  # file names may contain spaces
        pts = raw[i + 1].split() if i + 1 < len(raw) else []
        trip = np.asarray([float(x) for x in pts]).reshape(-1, 3) if pts else np.zeros((0, 3))
        out[image_id] = ColmapImage(
            image_id, qvec, tvec, camera_id, name,
            xys=trip[:, :2], point3d_ids=trip[:, 2].astype(np.int64),
        )
    return out


def read_points3d_text(path: str) -> ColmapPoints:
    ids, xyzs, rgbs, errs = [], [], [], []
    for line in _text_lines(path):
        parts = line.split()
        ids.append(int(parts[0]))
        xyzs.append([float(x) for x in parts[1:4]])
        rgbs.append([int(x) for x in parts[4:7]])
        errs.append(float(parts[7]))
    return ColmapPoints(
        ids=np.asarray(ids, np.int64),
        xyz=np.asarray(xyzs, np.float64).reshape(-1, 3),
        rgb=np.asarray(rgbs, np.uint8).reshape(-1, 3),
        error=np.asarray(errs, np.float64),
    )


# --- writers (for tests / synthetic fixtures) --------------------------------


def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.camera_id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            m = len(im.point3d_ids)
            f.write(struct.pack("<Q", m))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3d_binary(pts: ColmapPoints, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts.ids)))
        for pid, xyz, rgb, err in zip(pts.ids, pts.xyz, pts.rgb, pts.error):
            f.write(struct.pack("<Qdddbbbd", int(pid), *xyz,
                                int(rgb[0]) - 256 if rgb[0] > 127 else int(rgb[0]),
                                int(rgb[1]) - 256 if rgb[1] > 127 else int(rgb[1]),
                                int(rgb[2]) - 256 if rgb[2] > 127 else int(rgb[2]),
                                float(err)))
            f.write(struct.pack("<Q", 0))


# --- top level ---------------------------------------------------------------


def load_reconstruction(path: str) -> Reconstruction:
    """Load a COLMAP sparse model directory (auto-detects .bin vs .txt)."""
    rec = Reconstruction()
    if os.path.exists(os.path.join(path, "cameras.bin")):
        rec.cameras = read_cameras_binary(os.path.join(path, "cameras.bin"))
        rec.images = read_images_binary(os.path.join(path, "images.bin"))
        rec.points = read_points3d_binary(os.path.join(path, "points3D.bin"))
    elif os.path.exists(os.path.join(path, "cameras.txt")):
        rec.cameras = read_cameras_text(os.path.join(path, "cameras.txt"))
        rec.images = read_images_text(os.path.join(path, "images.txt"))
        rec.points = read_points3d_text(os.path.join(path, "points3D.txt"))
    else:
        raise FileNotFoundError(f"No COLMAP model (cameras.bin/.txt) in {path}")
    return rec
