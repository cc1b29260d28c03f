"""MCMC densification: relocation + noise injection on fixed-capacity tensors.

Torch port of ``tinysplat_tpu.models.densify_mcmc`` (the 3DGS-MCMC strategy
of Kheradmand et al. 2024, with the semantics of gsplat's ``MCMCStrategy``):
live splats whose opacity fell below ``mcmc_min_opacity`` are relocated onto
live splats sampled with probability proportional to opacity, free slots
grow the live count by ``mcmc_growth_factor`` toward the cap, and every step
the means get covariance-shaped noise gated to near-dead splats. Capacity
never grows: the cap is the capacity.

Relocation math (paper eq. 9): a splat of opacity o split into r copies
keeps its rendered footprint when

    o_new     = 1 - (1 - o)^(1/r)
    scale_new = scale * o / sum_{i=1..r} sum_{k=0..i-1}
                  C(i-1, k) (-1)^k o_new^(k+1) / sqrt(k+1)

with the double sum as a per-k coefficient table (``_coeff_table``).

**In place**, as ``models/densify.py``: ``relocate_and_grow`` writes the
parameter tensors and the optimizer's moments (``GaussianAdam.moment_pairs``)
under ``torch.no_grad()``, and zeroes the moments and the densify
accumulator of every changed slot; ``apply_noise`` adds to the means.

The draws are arguments: the uniform ``u`` (C,) of the target sampling and
the standard normals ``eps`` (C, 3) of the noise; a ``torch.Generator``
draws them when absent, tests pass the JAX package's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
from math import comb, sqrt
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils.quaternions import quat_to_rotmat
from .densify import _expand
from .gaussians import PARAM_FIELDS, GaussianParams, GaussianState

R_MAX = 32  # max relocation multiplicity per target (gsplat caps at 51)


def _coeff_table() -> np.ndarray:
    """(R_MAX + 1, R_MAX) table: row r, col k holds
    sum_{i=k+1..r} C(i-1, k) (-1)^k / sqrt(k+1), so that
    denom(o, r) = sum_k table[r, k] o^(k+1)."""
    t = np.zeros((R_MAX + 1, R_MAX), np.float64)
    for r in range(1, R_MAX + 1):
        for i in range(1, r + 1):
            for k in range(i):
                t[r, k] += comb(i - 1, k) * ((-1.0) ** k) / sqrt(k + 1.0)
    return t.astype(np.float32)


_COEFFS = _coeff_table()


def relocation_adjustment(opacity: torch.Tensor, ratio: torch.Tensor):
    """(o_new, scale_mult) for splitting splats into ``ratio`` copies.

    opacity: (...,) in (0, 1); ratio: (...,) int >= 1 (clipped to R_MAX).
    Returns the per-copy opacity and the multiplier on exp(scales)."""
    ratio = torch.clamp(ratio.long(), 1, R_MAX)
    o = torch.clamp(opacity, 1e-7, 1.0 - 1e-7)
    o_new = 1.0 - torch.pow(1.0 - o, 1.0 / ratio.to(o.dtype))
    coeffs = torch.as_tensor(_COEFFS, device=o.device)[ratio]  # (..., R_MAX)
    powers = torch.pow(o_new[..., None],
                       torch.arange(1, R_MAX + 1, dtype=o.dtype, device=o.device))
    denom = torch.sum(coeffs * powers, dim=-1)
    return o_new, o / torch.clamp(denom, min=1e-12)


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    return torch.log(p) - torch.log1p(-p)


def relocation_targets(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling: for each uniform ``u`` in [0, 1), the slot whose
    cumulative ``probs`` step holds u * total (clipped to the slots).

    The cumulative sum is taken in float64. In float32, CUDA's scan adds its
    tiles' prefixes in an order that varies from run to run: over 1M
    opacities on an H100 the sums moved by up to 0.0625 of a 338,729 total
    between two runs, which moved 1.6% of the targets."""
    cdf = torch.cumsum(probs.to(torch.float64), dim=0)
    target = torch.searchsorted(cdf, u.to(torch.float64) * cdf[-1], right=True)
    return torch.clamp(target, 0, probs.shape[0] - 1)


@torch.no_grad()
def relocate_and_grow(
    state: GaussianState,
    opt_state,
    cfg: Config,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[GaussianState, object, Dict[str, int]]:
    """One MCMC refine pass: relocate dead splats and grow toward the cap.

    1. Sources: live splats with sigmoid(opacity) < mcmc_min_opacity, plus
       the first free slots that grow the live count by
       mcmc_growth_factor (toward min(mcmc_cap or capacity, max_gaussians)).
    2. Each source samples a target among the other live splats with
       probability proportional to opacity (``relocation_targets`` with the
       uniform ``u`` (C,), drawn from ``generator`` when None).
    3. A target with n sources becomes n + 1 copies: its opacity (clamped to
       at least mcmc_min_opacity per copy) and scales are adjusted by
       ``relocation_adjustment``, the sources copy the adjusted target, and
       the Adam moments and accumulator of sources and touched targets are
       zeroed.

    Returns (state, opt_state, stats) with int stats relocated / grown /
    num_live (and cloned / split / pruned / dropped, all 0).
    """
    params, alive = state.params, state.alive
    cap = params.capacity
    dev = alive.device
    o = torch.sigmoid(params.opacities[:, 0])

    dead_live = alive & (o < cfg.mcmc_min_opacity)
    n_live = alive.sum().to(torch.int32)
    cap_target = min(cfg.mcmc_cap or cap, cfg.max_gaussians, cap)
    n_target = torch.clamp((n_live.to(torch.float32) * cfg.mcmc_growth_factor)
                           .to(torch.int32), max=cap_target)
    n_grow = torch.clamp(n_target - n_live, min=0)
    free_rank = torch.cumsum((~alive).to(torch.int32), 0) - 1
    grow_mask = ~alive & (free_rank < n_grow)
    src_mask = dead_live | grow_mask

    probs = torch.where(alive & ~src_mask, o, 0.0)
    if u is None:
        u = torch.rand((cap,), generator=generator, device=dev)
    target = relocation_targets(probs, torch.as_tensor(u, device=dev))
    ok = probs.sum() > 0.0  # nothing to sample from: a no-op

    counts = torch.zeros((cap,), dtype=torch.int64, device=dev).scatter_add_(
        0, target, src_mask.long())
    o_new, scale_mult = relocation_adjustment(o, 1 + counts)
    # The per-copy opacity is clamped to the floor, so a barely-live target
    # split r ways is not born below it (and relocated again next pass).
    o_new = torch.clamp(o_new, min=cfg.mcmc_min_opacity)
    touched = (counts > 0) & alive & ok
    place = src_mask & ok
    changed = place | touched

    adjusted = {
        "opacities": torch.where(touched[:, None], _logit(o_new)[:, None], params.opacities),
        "scales": torch.where(touched[:, None], params.scales + torch.log(scale_mult)[:, None],
                              params.scales),
    }
    for name in PARAM_FIELDS:
        v = getattr(params, name)
        adj = adjusted.get(name, v)
        v.copy_(torch.where(_expand(place, v), adj[target], adj))
    if opt_state is not None:
        for _, m, v in opt_state.moment_pairs():
            m.masked_fill_(_expand(changed, m), 0.0)
            v.masked_fill_(_expand(changed, v), 0.0)

    new_alive = alive | place
    new_state = dataclasses.replace(
        state, alive=new_alive,
        means_grad_accum=torch.where(changed, 0.0, state.means_grad_accum))
    relocated, grown, num_live = torch.stack(
        [(dead_live & ok).sum(), (grow_mask & ok).sum(), new_alive.sum()]).tolist()
    stats = {"relocated": relocated, "grown": grown, "num_live": num_live,
             "cloned": 0, "split": 0, "pruned": 0, "dropped": 0}
    return new_state, opt_state, stats


@torch.no_grad()
def apply_noise(params: GaussianParams, alive: torch.Tensor, eps: torch.Tensor,
                lr_scaler: float, cfg: Config) -> GaussianParams:
    """Add the per-step position noise with the standard normals ``eps``
    (C, 3) given, in place: means += Sigma eps * gate(o) * lr_scaler over
    live splats, with Sigma = R diag(exp(2 scales)) R^T and
    gate(o) = sigmoid(100 ((1 - o) - 0.995)), so only near-dead splats
    (o below ~0.005) move. Returns ``params``."""
    o = torch.sigmoid(params.opacities[:, 0])
    gate = torch.sigmoid(100.0 * ((1.0 - o) - 0.995))
    R = quat_to_rotmat(params.quats)  # (C, 3, 3)
    s2 = torch.exp(2.0 * params.scales)
    eps = torch.as_tensor(eps, dtype=params.means.dtype, device=params.means.device)
    v = (R * eps[:, :, None]).sum(dim=1) * s2  # S^2 R^T eps
    v = (R * v[:, None, :]).sum(dim=2)  # R S^2 R^T eps
    params.means.add_(v * (gate * alive.to(v.dtype) * lr_scaler)[:, None])
    return params


def inject_noise(params: GaussianParams, alive: torch.Tensor, lr_scaler: float, cfg: Config,
                 generator: Optional[torch.Generator] = None) -> GaussianParams:
    """``apply_noise`` with eps drawn from ``generator`` on the means'
    device. The train step calls it after the Adam update."""
    eps = torch.randn(tuple(params.means.shape), generator=generator,
                      device=params.means.device)
    return apply_noise(params, alive, eps, lr_scaler, cfg)
