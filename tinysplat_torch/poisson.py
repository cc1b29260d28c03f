"""Screened Poisson surface reconstruction on the device (torch port of
``tinysplat_tpu.poisson``).

1. outlier removal: the statistical distance-to-neighbours filter (Open3D's
   remove_statistical_outlier rule);
2. normals: the k-NN PCA plane fit per point (the smallest covariance
   eigenvector), oriented toward the camera each point was seen from;
3. indicator solve: the oriented normals splatted into a uniform vector
   grid V with trilinear weights, and (laplacian - screen) chi = div V
   solved spectrally: ``torch.fft.fftn``, one division, ``torch.fft.ifftn``,
   on the device of the points (a CUDA tensor stays on the card; there is
   no host FFT);
4. iso level: the median indicator value at the input samples, surfaced by
   the marching-tetrahedra kernel of ``mesh.py``, and the vertices with the
   least sample support (the bottom ``density_quantile``) trimmed.

``reconstruct(..., timings=dict)`` writes each stage's seconds there
(``outliers``, ``normals``, ``fft_solve``, ``iso_surface``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .utils.device import resolve_device, timed


def knn_points(points: torch.Tensor, k: int = 16, chunk: Optional[int] = None) -> torch.Tensor:
    """(P, k) indices of each point's k nearest neighbours (itself
    included): ``regularizers.density.knn_indices`` as a self-query; k is
    clamped to the point count there."""
    from .regularizers.density import knn_indices

    alive = torch.ones((points.shape[0],), dtype=torch.bool, device=points.device)
    return knn_indices(points, points, alive, k=k, chunk=chunk)


@torch.no_grad()
def estimate_normals(points: torch.Tensor, view_origins: Optional[torch.Tensor] = None,
                     k: int = 16) -> torch.Tensor:
    """Per-point unit normals via k-NN PCA: the eigenvector of the
    neighbourhood covariance with the smallest eigenvalue, flipped to face
    ``view_origins`` (the camera position each point was acquired from,
    (P, 3)) when given."""
    idx = knn_points(points, k=k)
    nbrs = points[idx]  # (P, k, 3)
    d = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = (d[..., :, None] * d[..., None, :]).sum(dim=1) / k  # (P, 3, 3)
    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    normals = vecs[:, :, 0]
    if view_origins is not None:
        sign = torch.sign(torch.sum(normals * (view_origins - points), dim=-1, keepdim=True))
        normals = normals * torch.where(sign == 0, 1.0, sign)
    return normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-12)


def remove_statistical_outliers(points: np.ndarray, nb_neighbors: int = 20,
                                std_ratio: float = 2.0, device="cuda") -> np.ndarray:
    """Indices of the inlier points (Open3D's remove_statistical_outlier
    rule): keep the points whose mean k-NN distance is within
    mean + std_ratio * std. The KNN runs on ``device``."""
    pts = torch.as_tensor(np.asarray(points, np.float32), device=resolve_device(device))
    idx = knn_points(pts, k=min(nb_neighbors + 1, len(points))).cpu().numpy()
    nbrs = points[idx[:, 1:]]  # skip self
    dist = np.linalg.norm(nbrs - points[:, None, :], axis=-1).mean(axis=1)
    thresh = dist.mean() + std_ratio * dist.std()
    return np.where(dist <= thresh)[0]


def _corner_weights(points_g: torch.Tensor, base: torch.Tensor):
    """(offset (3,), trilinear weight (P,)) of each of a cell's 8 corners."""
    frac = points_g - base
    for corner in range(8):
        off = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1],
                           device=points_g.device)
        yield off, torch.prod(torch.where(off[None, :] == 1, frac, 1.0 - frac), dim=-1)


def _splat_trilinear(points_g: torch.Tensor, values: torch.Tensor, res: int) -> torch.Tensor:
    """Scatter per-point vectors into a (res, res, res, C) grid, trilinear."""
    base = torch.floor(points_g).to(torch.int64)
    grid = torch.zeros((res * res * res, values.shape[-1]), dtype=values.dtype,
                       device=values.device)
    for off, w in _corner_weights(points_g, base.to(points_g.dtype)):
        idx3 = torch.clamp(base + off[None, :], 0, res - 1)
        flat = (idx3[:, 0] * res + idx3[:, 1]) * res + idx3[:, 2]
        grid.index_add_(0, flat, w[:, None] * values)
    return grid.reshape(res, res, res, -1)


def _spectral_solve(vgrid: torch.Tensor, resolution: int, screen: float) -> torch.Tensor:
    """Spectral divergence and inverse screened Laplacian of the (R, R, R, 3)
    vector grid, on its device: chi_hat = i k.V_hat / -(|k|^2 + screen_hat)
    (0 at k = 0), chi = Re ifftn(chi_hat). The screening, expressed in
    cells, regularizes the near-DC modes."""
    freqs = torch.fft.fftfreq(resolution, device=vgrid.device).to(torch.float32) * (
        2.0 * np.pi)
    kx, ky, kz = freqs[:, None, None], freqs[None, :, None], freqs[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    screen_hat = screen * (2.0 * np.pi / resolution) ** 2
    vhat = torch.fft.fftn(vgrid, dim=(0, 1, 2))
    div_hat = 1j * (kx * vhat[..., 0] + ky * vhat[..., 1] + kz * vhat[..., 2])
    chi_hat = torch.where(k2 > 0, div_hat / -(k2 + screen_hat), 0.0)
    return torch.fft.ifftn(chi_hat, dim=(0, 1, 2)).real


@torch.no_grad()
def solve_indicator(points: torch.Tensor, normals: torch.Tensor, resolution: int = 128,
                    padding: float = 0.25, screen: float = 4.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, float, float]:
    """Spectral screened-Poisson solve for the indicator function.

    Solves (lap - screen_hat) chi = div V for the normal field V splatted
    on a regular grid (a periodic domain; ``padding`` keeps the surface
    away from the wrap-around). Returns (chi (R, R, R) on the points'
    device, origin (3,), spacing, iso), iso the median of chi at the
    samples."""
    lo, hi = points.amin(dim=0), points.amax(dim=0)
    span = torch.max(hi - lo) * (1.0 + padding)
    origin = (hi + lo) / 2.0 - span / 2.0
    spacing = span / (resolution - 1)
    pts_g = (points - origin[None]) / spacing
    # V points along the OUTWARD normals and the indicator grows inward,
    # so the right-hand side carries a minus sign.
    chi = _spectral_solve(_splat_trilinear(pts_g, -normals, resolution), resolution, screen)

    base = torch.clamp(torch.floor(pts_g).to(torch.int64), 0, resolution - 2)
    acc = torch.zeros_like(pts_g[:, 0])
    for off, w in _corner_weights(pts_g, base.to(pts_g.dtype)):
        idx3 = base + off[None, :]
        acc = acc + w * chi[idx3[:, 0], idx3[:, 1], idx3[:, 2]]
    iso = torch.quantile(acc, 0.5)  # the mean of the middle two, as np.median
    return chi, origin, float(spacing), float(iso)


def _empty_mesh():
    empty3 = np.zeros((0, 3), np.float32)
    return empty3, np.zeros((0, 3), np.int32), empty3


def iso_surface(chi: np.ndarray, origin: np.ndarray, spacing: float, iso: float,
                points: torch.Tensor, density_quantile: float = 0.1
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(vertices, faces, normals) of the indicator's iso-surface at ``iso``
    (marching tetrahedra), with the vertices whose sample support (the
    trilinear splat count of ``points``, blurred one cell) is in the bottom
    ``density_quantile`` removed."""
    from .mesh import marching_tetrahedra, vertex_normals

    resolution = chi.shape[0]
    origin = np.asarray(origin)
    verts, faces = marching_tetrahedra(chi, iso, origin, float(spacing))
    if len(verts) and density_quantile > 0:
        pts_g = (points - torch.tensor(origin, device=points.device)[None]) / spacing
        ones = torch.ones((points.shape[0], 1), dtype=points.dtype, device=points.device)
        mass = _splat_trilinear(pts_g, ones, resolution)[..., 0].cpu().numpy()
        for ax in range(3):  # blurred, so thin-sampled surfaces survive
            mass = mass + np.roll(mass, 1, axis=ax) + np.roll(mass, -1, axis=ax)
        vg = np.clip(((verts - origin[None]) / spacing).round().astype(np.int64), 0,
                     resolution - 1)
        support = mass[vg[:, 0], vg[:, 1], vg[:, 2]]
        ok = support > np.quantile(support, density_quantile)
        remap = -np.ones(len(verts), np.int64)
        remap[ok] = np.arange(ok.sum())
        fok = ok[faces].all(axis=1)
        verts = verts[ok]
        faces = remap[faces[fok]]
    return verts, faces, vertex_normals(verts, faces)


def reconstruct(
    points: np.ndarray,
    view_origins: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    resolution: int = 128,
    screen: float = 4.0,
    outlier_std_ratio: float = 20.0,
    density_quantile: float = 0.1,
    device="cuda",
    timings: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oriented points -> (vertices, faces, normals), on ``device``: outlier
    removal, normals (unless given), the indicator solve and the
    iso-surface. 16 or fewer points give an empty mesh."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    if len(pts) <= 16:
        return _empty_mesh()
    with timed(timings, "outliers", dev):
        keep = remove_statistical_outliers(pts, std_ratio=outlier_std_ratio, device=dev)
    pts = pts[keep]
    if len(pts) <= 16:
        return _empty_mesh()
    pts_t = torch.as_tensor(pts, device=dev)
    with timed(timings, "normals", dev):
        if normals is None:
            vo = None if view_origins is None else torch.as_tensor(
                np.asarray(view_origins, np.float32)[keep], device=dev)
            nrm = estimate_normals(pts_t, vo)
        else:
            nrm = torch.as_tensor(np.asarray(normals, np.float32)[keep], device=dev)
    with timed(timings, "fft_solve", dev):
        chi, origin, spacing, iso = solve_indicator(pts_t, nrm, resolution=resolution,
                                                    screen=screen)
    with timed(timings, "iso_surface", dev):
        return iso_surface(chi.cpu().numpy(), origin.cpu().numpy(), spacing, iso, pts_t,
                           density_quantile)
