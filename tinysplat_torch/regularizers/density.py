"""SuGaR-style density / SDF regularization (Guédon & Lepetit 2023, eqs. 1+5).

Torch port of ``tinysplat_tpu.regularizers.density``, with its semantics:

- points are sampled from the splat mixture, each splat drawn with
  probability proportional to its ellipsoid's area (prod of its scales),
  by a float64 inverse CDF of uniforms (a draw the card repeats exactly);
- the mixture density at a point sums opacity-weighted Gaussians over its
  K = 16 nearest live splats; the inverse covariance is the analytic
  R diag(s^-2) R^T;
- the KNN is chunked brute force: ||m||^2 - 2 p.m^T per chunk (one matmul),
  then a top-k, equal distances broken by the lower index. The per-row
  constant ||p||^2 changes no row's order, so it is left out. The product
  runs in full float32 (TF32 off for the call): with means far from the
  origin, TF32's 10-bit mantissa in -2 p.m picks wrong neighbours. The
  host reads twice per call, never per chunk;
- the *approximate* density comes from the rendered depth map: project each
  point, sample the depth bilinearly (border clamped), sdf = depth - z_cam,
  density ~ exp(-sdf^2 / (2 beta^2));
- loss: |d - d_hat| masked mean, or |beta sqrt(-2 log d) - sdf_hat| (SDF).

The draws are arguments: ``sample_points`` takes its splat indices and
standard normals, and draws them from a ``torch.Generator`` when absent
(tests pass the JAX package's ``jax.random`` draws).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch

from ..cameras import CameraParams
from ..models.densify_mcmc import relocation_targets
from ..models.gaussians import GaussianParams
from ..utils.device import timed
from ..utils.profiling import span
from ..utils.quaternions import quat_to_rotmat

# Elements of one chunk's (chunk, N) distance block: 2^27 float32 = 512 MiB.
KNN_BLOCK_ELEMS = 1 << 27


@contextlib.contextmanager
def _full_f32_matmul():
    """Float32 matmuls in full precision (no TF32) for the enclosed calls."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def covariance_inverse(params: GaussianParams) -> torch.Tensor:
    """(N, 3, 3) inverse covariances Sigma^-1 = R diag(s^-2) R^T."""
    R = quat_to_rotmat(params.quats)
    inv_s2 = torch.exp(-2.0 * params.scales)
    return torch.einsum("nij,nj,nkj->nik", R, inv_s2, R)


class DensityProbe(NamedTuple):
    """Cached per-interval density-regularizer inputs."""

    points: torch.Tensor  # (S, 3) sampled surface-candidate points
    knn_idx: torch.Tensor  # (S, K) nearest-splat indices (int64)
    beta: torch.Tensor  # (S,) SDF length scale per point


def _rotate(R: torch.Tensor, v: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """R v (or R^T v) for (..., 3, 3) R and (..., 3) v, elementwise (no
    matmul, so no TF32)."""
    if transpose:
        return (R * v[..., :, None]).sum(dim=-2)
    return (R * v[..., None, :]).sum(dim=-1)


@torch.no_grad()
def sample_points(
    params: GaussianParams,
    alive: torch.Tensor,
    num_samples: int,
    idxs: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample points from the splat mixture, weighted by ellipsoid area.

    ``idxs`` (S,) are the sampled splats (drawn by area from ``generator``
    when None; dead splats never), ``eps`` (S, 3) the standard normals of
    the offsets (drawn when None). Returns (points (S, 3), idxs).

    The draw is S uniforms from ``generator``, each mapped to its splat by
    the float64 cumulative area (``relocation_targets``), then the normals.
    ``torch.multinomial`` is not used: its float32 scan on the card adds in
    an order that varies between calls, and over 262,144 splats on an H100
    10-447 of 100,000 draws moved between two calls from one generator
    state."""
    dev = params.means.device
    scales = torch.exp(params.scales)
    if idxs is None:
        if not bool(alive.any()):
            raise ValueError("sample_points: no live splats to sample from")
        areas = torch.where(alive, torch.abs(torch.prod(scales, dim=-1)), 0.0)
        u = torch.rand((num_samples,), generator=generator, device=dev)
        idxs = relocation_targets(areas, u)
    idxs = torch.as_tensor(idxs, device=dev).long()
    if eps is None:
        eps = torch.randn((num_samples, 3), generator=generator, device=dev)
    eps = torch.as_tensor(eps, dtype=params.means.dtype, device=dev)
    offs = _rotate(quat_to_rotmat(params.quats[idxs]), eps * scales[idxs])
    return params.means[idxs] + offs, idxs


def _by_value_then_index(vals: torch.Tensor, idx: torch.Tensor):
    """Each row of (vals, idx) reordered by value, equal values by index."""
    order = torch.argsort(idx, dim=1)
    vals, idx = vals.gather(1, order), idx.gather(1, order)
    order = torch.argsort(vals, dim=1, stable=True)
    return vals.gather(1, order), idx.gather(1, order)


def _value_index_keys(d: torch.Tensor) -> torch.Tensor:
    """int64 keys of a float32 (R, N) block that order as (value, column):
    the float's bits made order-preserving as int32, times 2^32, plus the
    column."""
    bits = d.contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    cols = torch.arange(d.shape[1], device=d.device)
    return bits.long() * (1 << 32) + cols


@torch.no_grad()
def knn_indices(
    points: torch.Tensor,
    means: torch.Tensor,
    alive: torch.Tensor,
    k: int = 16,
    chunk: Optional[int] = None,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """(S, k) int64 indices of the k nearest live splat means of each
    point, nearest first, equal distances by the lower index (as
    ``jax.lax.top_k``: MCMC copies sit exactly on their target).

    Chunked brute force: per chunk of points one (chunk, N) block of
    ||m||^2 - 2 p.m^T (an addmm) and a top-(k+1) per row, put in (value,
    index) order. Where the k-th and (k+1)-th values tie, the tie group may
    reach past the candidates: those rows (read once, after the chunks) are
    redone exactly with int64 (value, column) keys. Dead splats sit at +inf
    and are never chosen; k is clamped to the live count (when fewer than k
    splats live, the +inf ties would fill the rows with dead slots).
    ``chunk`` defaults to what keeps a block at ``KNN_BLOCK_ELEMS``. Two
    host reads per call: the live count and the tied rows. With a ``stats``
    dict, the count of rows redone is written there (``tied_rows``).
    """
    n_live = int(alive.sum())
    if n_live == 0:
        raise ValueError("knn_indices: no live splats to query against")
    k = min(k, n_live)
    kk = min(k + 1, means.shape[0])
    means = means.detach()
    points = points.detach().to(means.dtype)
    m_sq = torch.where(alive, torch.sum(means * means, dim=-1), torch.inf)[None, :]
    if chunk is None:
        chunk = max(1, KNN_BLOCK_ELEMS // max(means.shape[0], 1))
    out, ties = [], []
    with _full_f32_matmul():
        for i in range(0, points.shape[0], chunk):
            d = torch.addmm(m_sq, points[i:i + chunk], means.T, alpha=-2.0)
            vals, idx = _by_value_then_index(*torch.topk(d, kk, dim=1, largest=False))
            out.append(idx[:, :k])
            if kk > k:
                ties.append(vals[:, k - 1] == vals[:, k])
        if not out:
            return torch.zeros((0, k), dtype=torch.int64, device=means.device)
        idx = torch.cat(out)
        rows = torch.nonzero(torch.cat(ties))[:, 0] if ties else idx.new_zeros((0,))
        if stats is not None:
            stats["tied_rows"] = int(rows.shape[0])
        for j in range(0, rows.shape[0], max(1, chunk // 2)):
            r = rows[j:j + max(1, chunk // 2)]
            d = torch.addmm(m_sq, points[r], means.T, alpha=-2.0)
            idx[r] = torch.topk(_value_index_keys(d), k, dim=1, largest=False).indices
    return idx


def density_at_points(points: torch.Tensor, knn_idx: torch.Tensor,
                      params: GaussianParams) -> torch.Tensor:
    """Opacity-weighted Gaussian mixture density over the KNN set:
    d = sum_k sigmoid(o_k) exp(-0.5 mu^T Sigma_k^-1 mu), the quadratic form
    clamped to [0, 1e8] and d clamped to <= 1 + 1e-12."""
    mu = points[:, None, :] - params.means[knn_idx]  # (S, K, 3)
    R = quat_to_rotmat(params.quats[knn_idx])  # (S, K, 3, 3)
    inv_s2 = torch.exp(-2.0 * params.scales[knn_idx])  # (S, K, 3)
    # Sigma^-1 = R diag(s^-2) R^T  =>  q = || diag(s^-1) R^T mu ||^2
    rt_mu = _rotate(R, mu, transpose=True)
    q = torch.clamp(torch.sum(rt_mu * rt_mu * inv_s2, dim=-1), 0.0, 1e8)
    opac = torch.sigmoid(params.opacities[knn_idx, 0])
    d = torch.sum(torch.exp(-0.5 * q) * opac, dim=-1)
    return torch.where(d > 1.0, 1.0 + 1e-12, d)


def _bilinear_border(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (H, W) img at float pixel coords, border-clamped."""
    h, w = img.shape
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    fx, fy = x - x0, y - y0
    xi0, yi0, xi1, yi1 = (a.long() for a in (x0, y0, x1, y1))
    return (img[yi0, xi0] * (1 - fx) * (1 - fy) + img[yi0, xi1] * fx * (1 - fy)
            + img[yi1, xi0] * (1 - fx) * fy + img[yi1, xi1] * fx * fy)


def approximate_density(
    points: torch.Tensor,
    depth_map: torch.Tensor,
    camera: CameraParams,
    beta: torch.Tensor,
    img_height: int,
    img_width: int,
    znear: float = 0.001,
    return_sdf: bool = False,
):
    """Depth-map-based density (or SDF) estimate at world points.

    Transform to camera space, project to pixels (with the renderer's
    principal-point offset), sample the rendered depth bilinearly (border
    clamped): sdf_hat = depth(px) - z. Returns (estimate, mask): mask marks
    points inside the frustum; the estimate is exp(-sdf^2 / (2 beta^2)), or
    the sdf itself with ``return_sdf``."""
    view = camera.viewmat
    cam_pts = points @ view[:3, :3].T + view[:3, 3]
    z = cam_pts[:, 2]
    mask = z > znear
    hom = torch.cat([cam_pts, torch.ones_like(z[:, None])], dim=1) @ camera.projmat.T
    w = hom[:, 3:4]
    ndc = hom[:, :2] / torch.clamp(torch.abs(w), min=1e-9) * torch.sign(w)
    px = 0.5 * img_width * ndc[:, 0] + img_width / 2.0 + camera.cx_off - 0.5
    py = 0.5 * img_height * ndc[:, 1] + img_height / 2.0 + camera.cy_off - 0.5
    mask = mask & (px >= 0) & (px <= img_width - 1) & (py >= 0) & (py <= img_height - 1)
    sdf_hat = _bilinear_border(depth_map, px, py) - z
    if return_sdf:
        return sdf_hat, mask
    d_hat = torch.exp(-0.5 * sdf_hat ** 2 / torch.clamp(beta, min=1e-9) ** 2)
    return d_hat, mask


@torch.no_grad()
def make_density_probe(
    params: GaussianParams,
    alive: torch.Tensor,
    num_samples: int = 100_000,
    k: int = 16,
    idxs: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    timings: Optional[dict] = None,
) -> DensityProbe:
    """Refresh the cached sample points, their KNN and beta.

    ``idxs`` / ``eps`` / ``generator`` as in :func:`sample_points`. With a
    ``timings`` dict, the device is synchronized after each stage and the
    seconds of the sampling and of the KNN are written there
    (``sample_s``, ``knn_s``), with the KNN's count of tied rows
    (``tied_rows``). Spans ``ts.density.sample`` and ``ts.density.knn``
    cover the two stages, their syncs included."""
    dev = params.means.device
    with span("ts.density.sample"), timed(timings, "sample_s", dev):
        points, _ = sample_points(params, alive, num_samples, idxs, eps, generator)
    with span("ts.density.knn"), timed(timings, "knn_s", dev):
        idx = knn_indices(points, params.means, alive, k=k, stats=timings)
    # The loss recomputes beta from the live scales each step (probe_beta);
    # this snapshot is for inspection.
    return DensityProbe(points=points, knn_idx=idx, beta=probe_beta(params, idx))


def probe_beta(params: GaussianParams, knn_idx: torch.Tensor) -> torch.Tensor:
    """Per-point SDF length scale from the CURRENT scales: the mean over
    the K neighbours of each one's smallest scale axis (carries gradient
    into the scales)."""
    min_scale = torch.amin(torch.exp(params.scales), dim=-1)
    return torch.mean(min_scale[knn_idx], dim=-1)


def density_loss(
    probe: DensityProbe,
    params: GaussianParams,
    depth_map: torch.Tensor,
    camera: CameraParams,
    img_height: int,
    img_width: int,
    use_sdf: bool = False,
) -> torch.Tensor:
    """The scheduled density loss term: masked mean of |d - d_hat|, or of
    |beta sqrt(-2 log d) - sdf_hat| in SDF mode."""
    d = density_at_points(probe.points, probe.knn_idx, params)
    beta = probe_beta(params, probe.knn_idx)  # live scales, with gradient
    est, mask = approximate_density(probe.points, depth_map, camera, beta,
                                    img_height, img_width, return_sdf=use_sdf)
    if use_sdf:
        sdf = beta * torch.sqrt(-2.0 * torch.log(torch.clamp(d, 0.001, 0.999)))
        err = torch.abs(sdf - est)
    else:
        err = torch.abs(d - est)
    denom = torch.clamp(mask.to(err.dtype).sum(), min=1.0)
    return torch.where(mask, err, 0.0).sum() / denom
