"""The benchmark's inputs, made from ``--seed`` without the program.

- ``make_cloud``: a synthetic splat cloud on the device, drawn by one
  ``torch.Generator`` on that device in a few large calls, with the
  distributions of the splat recipe the configuration names (``recipe``):
  means ~ N(0, (0.4 extent)^2), log-scales of U(scale_range), unit
  quaternions from N(0, 1)^4, colours U(0, 1) as SH band 0, higher SH bands
  ~ N(0, sh_rest_std^2), opacity logits U(opacity_logit_range).
- ``jitter``: the trainee, the same cloud with its means moved by
  ``jitter_std`` N(0, 1) (a late-training state).
- ``orbit``: cameras on a horizontal orbit looking at the origin, as plain
  float32 matrices (the reference's and the program's cameras are both
  built from these numbers).

Parameters are returned as a dict of tensors keyed by ``LEAVES``, in the
layout the program and the reference share: means (N, 3), colors_dc (N, 3),
colors_rest (N, K - 1, 3), scales (N, 3) log-space, quats (N, 4) (w, x, y,
z), opacities (N, 1) logits.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

LEAVES = ("means", "colors_dc", "colors_rest", "scales", "quats", "opacities")
SH_C0 = 0.28209479177387814
SEED_MOD = 2**63 - 1  # torch.Generator seeds are unsigned 64-bit


def seed64(seed: int) -> int:
    """A seed of any size folded into what a ``torch.Generator`` takes."""
    return int(seed) % SEED_MOD


def make_cloud(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's splat cloud, drawn on ``device`` from ``seed``."""
    n = int(cfg["n_splats"])
    k = (int(cfg["sh_degree"]) + 1) ** 2
    lo, hi = cfg["scale_range"]
    olo, ohi = cfg["opacity_logit_range"]
    ext = float(cfg.get("extent", 1.0))
    g = torch.Generator(device=device).manual_seed(seed64(seed))

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    means = randn(n, 3) * (0.4 * ext)
    scales = torch.log((rand(n, 3) * (hi - lo) + lo) * ext)
    quats = randn(n, 4)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    colors_dc = (rand(n, 3) - 0.5) / SH_C0
    colors_rest = randn(n, k - 1, 3) * float(cfg["sh_rest_std"])
    opacities = rand(n, 1) * (ohi - olo) + olo
    return dict(means=means, colors_dc=colors_dc, colors_rest=colors_rest, scales=scales,
                quats=quats, opacities=opacities)


def jitter(cloud: Dict[str, torch.Tensor], std: float, seed: int) -> Dict[str, torch.Tensor]:
    """A copy of ``cloud`` with its means moved by ``std`` N(0, 1), drawn from
    a generator of its own (seeded from ``seed``) on the cloud's device."""
    dev = cloud["means"].device
    g = torch.Generator(device=dev).manual_seed(seed64(seed * 2 + 1))
    out = {k: v.clone() for k, v in cloud.items()}
    out["means"] = out["means"] + std * torch.randn(out["means"].shape, generator=g,
                                                    device=dev)
    return out


class OrbitCamera(NamedTuple):
    """One pinhole camera as float32 numbers (camera looks down +z)."""

    name: str
    position: np.ndarray  # (3,) float32
    view: np.ndarray  # (4, 4) float32 world -> camera
    proj: np.ndarray  # (4, 4) float32 camera -> clip, w = z
    fx: float
    fy: float
    fov_x: float
    fov_y: float
    width: int
    height: int


def proj_matrix(fov_x: float, fov_y: float, znear: float = 0.001,
                zfar: float = 1000.0) -> np.ndarray:
    """Perspective matrix with +z forward and w = z (gsplat's legacy layout)."""
    proj = np.zeros((4, 4), np.float64)
    proj[0, 0] = 1.0 / np.tan(fov_x / 2)
    proj[1, 1] = 1.0 / np.tan(fov_y / 2)
    proj[2, 2] = (zfar + znear) / (zfar - znear)
    proj[2, 3] = -1.0 * zfar * znear / (zfar - znear)
    proj[3, 2] = 1.0
    return proj.astype(np.float32)


def orbit(thetas, width: int, height: int, radius: float, height_frac: float,
          fov: float, prefix: str) -> List[OrbitCamera]:
    """Cameras at angles ``thetas`` (radians) on a circle of ``radius`` at
    height ``height_frac * radius``, looking at the origin, image up = -y."""
    f_x = width / (2 * np.tan(fov / 2))
    f_y = height / (2 * np.tan(fov / 2))
    fov_x = 2 * np.arctan(width / (2 * f_x))
    fov_y = 2 * np.arctan(height / (2 * f_y))
    cams = []
    for i, theta in enumerate(thetas):
        pos = radius * np.asarray([np.sin(theta), height_frac, np.cos(theta)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(np.asarray([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(fwd, right), fwd], axis=0)
        view = np.zeros((4, 4), np.float64)
        view[:3, :3] = rot
        view[:3, 3] = -rot @ pos
        view[3, 3] = 1.0
        cams.append(OrbitCamera(f"{prefix}_{i:03d}", pos.astype(np.float32),
                                view.astype(np.float32), proj_matrix(fov_x, fov_y),
                                float(f_x), float(f_y), float(fov_x), float(fov_y),
                                int(width), int(height)))
    return cams


def training_views(cfg: dict, traffic: dict) -> List[OrbitCamera]:
    """The trainee's views: ``views`` cameras evenly round the orbit."""
    n = int(traffic["views"])
    return orbit([2 * math.pi * i / n for i in range(n)], cfg["width"], cfg["height"],
                 traffic["orbit_radius"], traffic["orbit_height"], traffic["fov"], "view")


def novel_poses(cfg: dict, traffic: dict) -> List[OrbitCamera]:
    """``poses`` cameras on the same orbit at angles 2 pi (j + 1/2) / poses,
    none of them on a training view."""
    n = int(traffic["poses"])
    return orbit([2 * math.pi * (j + 0.5) / n for j in range(n)], cfg["width"],
                 cfg["height"], traffic["orbit_radius"], traffic["orbit_height"],
                 traffic["fov"], "pose")
