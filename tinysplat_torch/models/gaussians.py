"""Gaussian splat parameters: fixed-capacity tensors + an ``alive`` mask.

Torch port of ``tinysplat_tpu.models.gaussians``, with the same field
names, shapes and activations:

  means (C, 3) world positions;  scales (C, 3) log-scales;  quats (C, 4)
  unnormalized (w, x, y, z);  colors_dc (C, 3) SH band 0;  colors_rest
  (C, K-1, 3) higher SH bands;  opacities (C, 1) logits.

Dead slots (``alive`` False) hold benign sentinels: identity quats, scales
of -10 and opacity logits of -20. For training, ``requires_grad_`` makes the
six tensors trainable leaves, which the optimizer updates in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.sh import deg_from_sh, num_sh_bases
from ..utils.color import RGB2SH
from ..utils.device import resolve_device
from ..utils.quaternions import random_quats

PARAM_FIELDS = ("means", "colors_dc", "colors_rest", "scales", "quats", "opacities")


@dataclasses.dataclass
class GaussianParams:
    """The six learnable per-splat tensors (leading dim = capacity)."""

    means: torch.Tensor  # (C, 3)
    colors_dc: torch.Tensor  # (C, 3)
    colors_rest: torch.Tensor  # (C, K-1, 3)
    scales: torch.Tensor  # (C, 3) log-space
    quats: torch.Tensor  # (C, 4)
    opacities: torch.Tensor  # (C, 1) logit-space

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_bases(self) -> int:
        return self.colors_rest.shape[1] + 1

    def sh_coeffs(self) -> torch.Tensor:
        """(C, K, 3) concatenated SH coefficients (dc first)."""
        return torch.cat([self.colors_dc[:, None, :], self.colors_rest], dim=1)

    def fields(self) -> List[Tuple[str, torch.Tensor]]:
        """(name, tensor) of the six fields, in the JAX package's leaf order."""
        return [(name, getattr(self, name)) for name in PARAM_FIELDS]

    def requires_grad_(self, requires_grad: bool = True) -> "GaussianParams":
        """Make the six tensors trainable leaves (in place); returns self."""
        for name, t in self.fields():
            if not t.is_leaf:
                raise ValueError(f"{name} is not a leaf tensor and cannot be trained")
            t.requires_grad_(requires_grad)
        return self


@dataclasses.dataclass
class GaussianState:
    """Parameters + the structural and bookkeeping tensors."""

    params: GaussianParams
    alive: torch.Tensor  # (C,) bool — slot holds a live splat
    means_grad_accum: torch.Tensor  # (C,) accumulated ||dL/d xys|| for densify
    active_sh_degree: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.params.capacity

    def num_live(self) -> torch.Tensor:
        return self.alive.sum()


def _default_capacity(n: int) -> int:
    """Next power of two >= max(2N, 1024), as the JAX package picks it."""
    return max(1 << int(np.ceil(np.log2(max(2 * n, 1024)))), 1024)


def _knn_mean_log_dist(xyz: torch.Tensor, k: int = 3, block: int = 4096) -> torch.Tensor:
    """log(mean distance to the k nearest neighbors), per point.

    Exact brute force in row blocks (no matrix-product distance shortcut,
    which loses digits for near neighbours), so it needs no KNN library.
    """
    out = []
    for i in range(0, xyz.shape[0], block):
        d = torch.cdist(xyz[i:i + block], xyz,
                        compute_mode="donot_use_mm_for_euclid_dist")
        nearest = torch.topk(d, k + 1, dim=1, largest=False).values[:, 1:]
        out.append(nearest.mean(dim=1))
    mean_dist = torch.clamp(torch.cat(out), min=1e-10)
    return torch.log(mean_dist)


def _pad(arr: torch.Tensor, capacity: int, fill: float) -> torch.Tensor:
    out = torch.full((capacity,) + tuple(arr.shape[1:]), fill,
                     dtype=torch.float32, device=arr.device)
    out[: arr.shape[0]] = arr
    return out


def _logit(p: float) -> float:
    return float(np.log(p / (1.0 - p)))


def init_from_pcd(
    xyz: np.ndarray,
    colors: np.ndarray,
    sh_degree: int = 3,
    capacity: Optional[int] = None,
    opacity_init: float = 0.1,
    seed: int = 0,
    quats: Optional[np.ndarray] = None,
    device="cuda",
) -> GaussianState:
    """Initialize splats from a point cloud (the JAX package's semantics):
    SH dc from point colors, log-mean-3NN-distance isotropic scales, random
    rotations, opacity = logit(0.1), padded to ``capacity`` (default: next
    power of two >= 2N) with dead slots.

    Args:
      xyz: (N, 3) point positions.
      colors: (N, 3) point colors in [0, 255].
      quats: optional (N, 4) rotations to use instead of the draw from a
        ``torch.Generator`` seeded with ``seed`` (the JAX package draws with
        ``jax.random``, so parity tests pass its draw here).
    """
    dev = resolve_device(device)
    xyz_t = torch.tensor(np.asarray(xyz, np.float32), device=dev)
    colors_t = torch.tensor(np.asarray(colors, np.float32), device=dev)
    n = xyz_t.shape[0]
    if capacity is None:
        capacity = _default_capacity(n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")

    dim_sh = num_sh_bases(sh_degree)
    dc = RGB2SH(colors_t / 255.0)
    log_scales = _knn_mean_log_dist(xyz_t)
    if quats is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        quats_t = random_quats(gen, n, device=dev)
    else:
        quats_t = torch.tensor(np.asarray(quats, np.float32), device=dev)
    all_quats = torch.zeros((capacity, 4), dtype=torch.float32, device=dev)
    all_quats[:, 0] = 1.0
    all_quats[:n] = quats_t

    params = GaussianParams(
        means=_pad(xyz_t, capacity, 0.0),
        colors_dc=_pad(dc, capacity, 0.0),
        colors_rest=torch.zeros((capacity, dim_sh - 1, 3), device=dev),
        scales=_pad(log_scales[:, None].expand(n, 3), capacity, -10.0),
        quats=all_quats,
        # Dead slots get a very negative logit => sigmoid ~ 0 (invisible).
        opacities=_pad(torch.full((n, 1), _logit(opacity_init), device=dev),
                       capacity, -20.0),
    )
    return GaussianState(
        params=params,
        alive=torch.arange(capacity, device=dev) < n,
        means_grad_accum=torch.zeros((capacity,), device=dev),
        active_sh_degree=torch.tensor(1, dtype=torch.int32, device=dev),
    )


def state_dict(state: GaussianState) -> Dict[str, np.ndarray]:
    """Compact (live-only) numpy snapshot with the JAX package's keys: the
    six parameter arrays with dead slots stripped, plus the active degree."""
    alive = state.alive.detach().cpu().numpy()
    out = {}
    for name in PARAM_FIELDS:
        out[name] = getattr(state.params, name).detach().cpu().numpy()[alive]
    out["active_sh_degree"] = np.asarray(int(state.active_sh_degree), np.int32)
    return out


def from_state_dict(sd: Mapping[str, np.ndarray], capacity: Optional[int] = None,
                    device="cuda") -> GaussianState:
    """Rebuild a GaussianState from a compact snapshot: N from means, the SH
    degree from colors_rest, padded to ``capacity`` with dead slots."""
    dev = resolve_device(device)
    n = sd["means"].shape[0]
    if capacity is None:
        capacity = _default_capacity(n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} splats in the state dict")
    sh_degree = deg_from_sh(sd["colors_rest"].shape[1] + 1)

    def t(name):
        return torch.tensor(np.asarray(sd[name], np.float32), device=dev)

    # Dead-slot quats are the identity (w=1), never all-zero.
    quats = torch.zeros((capacity, 4), dtype=torch.float32, device=dev)
    quats[:, 0] = 1.0
    quats[:n] = t("quats")
    params = GaussianParams(
        means=_pad(t("means"), capacity, 0.0),
        colors_dc=_pad(t("colors_dc"), capacity, 0.0),
        colors_rest=_pad(t("colors_rest"), capacity, 0.0),
        scales=_pad(t("scales"), capacity, -10.0),
        quats=quats,
        opacities=_pad(t("opacities"), capacity, -20.0),
    )
    active = sd.get("active_sh_degree")
    active_deg = int(active) if active is not None else sh_degree
    return GaussianState(
        params=params,
        alive=torch.arange(capacity, device=dev) < n,
        means_grad_accum=torch.zeros((capacity,), device=dev),
        active_sh_degree=torch.tensor(active_deg, dtype=torch.int32, device=dev),
    )


# Dead-slot values of the fields whose zero is not benign (quats: identity).
SENTINELS = {"scales": -10.0, "opacities": -20.0}


def _dead_fill(name: str, t: torch.Tensor, dead: torch.Tensor) -> torch.Tensor:
    """``t`` (field ``name``) with the dead-slot sentinel written where
    ``dead``: identity quats, scales -10, opacity logits -20, zeros else."""
    mask = dead.reshape(dead.shape + (1,) * (t.dim() - 1))
    if name == "quats":
        ident = torch.zeros_like(t)
        ident[:, 0] = 1.0
        return torch.where(mask, ident, t)
    return torch.where(mask, SENTINELS.get(name, 0.0), t)


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Pad every capacity-sized tensor to ``new_capacity`` with dead slots
    (host-side and rare, as in the JAX package). Returns NEW tensors: the
    optimizer has to be rebuilt over them (``train.GaussianAdam.carried``)."""
    cap = state.capacity
    if new_capacity < cap:
        raise ValueError(f"new capacity {new_capacity} < current {cap}")
    dev = state.alive.device

    def pad(x):
        return torch.cat([x.detach(), x.new_zeros((new_capacity - cap,) + tuple(x.shape[1:]))])

    dead = torch.arange(new_capacity, device=dev) >= cap
    params = GaussianParams(**{name: _dead_fill(name, pad(t), dead)
                               for name, t in state.params.fields()})
    return GaussianState(params=params, alive=pad(state.alive),
                         means_grad_accum=pad(state.means_grad_accum),
                         active_sh_degree=state.active_sh_degree)


def compact_state(state: GaussianState, opt_state=None, min_capacity: int = 64,
                  margin: float = 2.0):
    """Repack live splats contiguously and shrink capacity (the inverse of
    ``grow_capacity``). Live order is kept (stable sort) and every Adam
    moment follows its splat.

    The target is the smallest power of two >= n_live * margin, never below
    ``min_capacity`` nor below n_live. Returns (state, opt_state,
    compacted): a no-op (False) when the target would not be smaller. ``opt_state`` is a ``train.GaussianAdam`` (or
    None); the compacted state holds new tensors, so it is rebuilt over
    them with its moments permuted and its count kept.
    """
    cap = state.capacity
    n_live = int(state.alive.sum())
    target = max(int(min_capacity),
                 1 << max(0, math.ceil(math.log2(max(n_live * margin, 1.0)))),
                 # A margin < 1 must never make compaction destroy live splats.
                 1 << max(0, math.ceil(math.log2(max(n_live, 1)))))
    if target >= cap:
        return state, opt_state, False
    perm = torch.argsort((~state.alive).to(torch.int8), stable=True)[:target]
    alive = state.alive[perm]
    dead = ~alive
    params = GaussianParams(**{
        name: (_dead_fill(name, t.detach()[perm], dead) if name in SENTINELS
               else t.detach()[perm].clone())
        for name, t in state.params.fields()})
    new_state = GaussianState(params=params, alive=alive,
                              means_grad_accum=state.means_grad_accum[perm],
                              active_sh_degree=state.active_sh_degree)
    if opt_state is not None:
        opt_state = opt_state.carried(params, lambda m: m[perm])
    return new_state, opt_state, True


def from_jax_params(d: Mapping[str, np.ndarray], device) -> GaussianState:
    """Carry a JAX-package state across as it stands, capacity and all.

    ``d`` maps the ``GaussianParams`` field names plus ``alive`` and
    ``active_sh_degree`` to numpy arrays (``np.asarray`` of the JAX
    leaves). Nothing is compacted or padded: slot i here is slot i there.
    """
    dev = resolve_device(device)
    params = GaussianParams(**{
        name: torch.tensor(np.asarray(d[name], np.float32), device=dev)
        for name in PARAM_FIELDS
    })
    alive = torch.tensor(np.asarray(d["alive"], bool), device=dev)
    return GaussianState(
        params=params,
        alive=alive,
        means_grad_accum=torch.zeros((params.capacity,), device=dev),
        active_sh_degree=torch.tensor(int(d["active_sh_degree"]), dtype=torch.int32,
                                      device=dev),
    )
