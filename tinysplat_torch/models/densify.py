"""Adaptive densification: clone / split / prune on fixed-capacity tensors.

Torch port of ``tinysplat_tpu.models.densify``, with its fixed-capacity
design kept exactly:

  1. grad_avg = means_grad_accum / interval / 2 * max(W, H);
     grad_mask = grad_avg >= tau_means, over live slots
  2. clone: grad_mask & max(exp(scales)) <  densify_scale_thresh (a copy)
  3. split: grad_mask & max(exp(scales)) >  densify_scale_thresh: two
     samples of N(mean, R diag(s^2) R^T), scales - log(phi)
  4. prune: (sigmoid(opacity) < 0.1 & max(exp(scales)) > 0.5) | split
     originals
  5. nothing happens while more than ``max_gaussians`` splats are live
  6. Adam moments: survivors keep theirs, every other slot is zeroed
  7. means_grad_accum resets to zero

Candidates live in a static (2, C) grid (clone = 1, split = 2 per slot);
valid ones are rank-compacted into the free slots in ascending index
order. Those beyond the free slots are dropped and counted:
``dropped = max(n_new - n_free, 0)``; the trainer then grows capacity and
runs the pass again.

**In place.** torch's Adam keys its state by tensor identity, and the train
step updates the parameter tensors in place. So these functions write, under
``torch.no_grad()``, into the parameter tensors and into the optimizer's
``exp_avg`` / ``exp_avg_sq`` (``GaussianAdam.moment_pairs``), and the
optimizer stays valid. They return the state (with new ``alive`` and
accumulator tensors, the same ``params``) and the same optimizer. Capacity
growth and compaction make new tensors instead and rebuild the optimizer
(``GaussianAdam.carried``).

The split draw ``eps`` (2, C, 3) is an argument: a ``torch.Generator``
draws it when absent, and tests pass the JAX package's ``jax.random`` draw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..config import Config
from ..utils.quaternions import quat_to_rotmat
from .gaussians import PARAM_FIELDS, GaussianState, _dead_fill


def _expand(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (t.dim() - 1))


def _keep_moments(opt_state, keep: torch.Tensor) -> None:
    """Zero every Adam moment outside ``keep``, in place."""
    if opt_state is None:
        return
    for _, m, v in opt_state.moment_pairs():
        m.masked_fill_(~_expand(keep, m), 0.0)
        v.masked_fill_(~_expand(keep, v), 0.0)


@torch.no_grad()
def densify_and_prune(
    state: GaussianState,
    opt_state,
    interval: int,
    max_dim: int,
    cfg: Config,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    keep_on_overflow: bool = False,
) -> Tuple[GaussianState, object, Dict[str, int]]:
    """One densify/prune pass (the caller gates on the step).

    Args:
      interval: steps since the last pass.
      max_dim: max(image width, height) of the training views.
      eps: (2, C, 3) standard-normal split draw; drawn from ``generator``
        on the state's device when None.
      keep_on_overflow: when the candidates overflow the free slots, write
        nothing and only report (the trainer grows capacity and reruns).

    Returns (state, opt_state, stats) with int stats cloned / split /
    pruned / dropped / num_live.
    """
    params, alive = state.params, state.alive
    cap = params.capacity
    dev = alive.device

    grad_avg = state.means_grad_accum / interval / 2.0 * max_dim
    grad_mask = (grad_avg >= cfg.tau_means) & alive
    scale_max = torch.exp(params.scales).amax(dim=-1)

    clone_mask = grad_mask & (scale_max < cfg.densify_scale_thresh)
    split_mask = grad_mask & (scale_max > cfg.densify_scale_thresh)
    prune_mask = ((torch.sigmoid(params.opacities[:, 0]) < 0.1) & (scale_max > 0.5)) | split_mask
    prune_mask = prune_mask & alive
    if int(alive.sum()) > cfg.max_gaussians:  # the reference's hard cap
        clone_mask = split_mask = prune_mask = torch.zeros_like(alive)
    survivors = alive & ~prune_mask

    n_cloned, n_split = int(clone_mask.sum()), int(split_mask.sum())
    n_new = n_cloned + 2 * n_split
    n_free = int((~survivors).sum())
    stats = {
        "cloned": n_cloned,
        "split": n_split,
        "pruned": int(prune_mask.sum()),
        "dropped": max(n_new - n_free, 0),
    }
    if keep_on_overflow and stats["dropped"] > 0:
        stats["num_live"] = int(alive.sum())
        return state, opt_state, stats

    # Candidate (0, i): clone copy or split sample 0; (1, i): split sample 1.
    if eps is None:
        eps = torch.randn((2, cap, 3), generator=generator, device=dev)
    R = quat_to_rotmat(params.quats)
    pert = torch.einsum("cij,scj->sci", R, eps * torch.exp(params.scales)[None])
    split_means = params.means[None] + pert
    split_scales = params.scales - math.log(cfg.phi)
    flat_valid = torch.stack([clone_mask | split_mask, split_mask]).reshape(-1)
    cand_rank = torch.cumsum(flat_valid.to(torch.int64), 0) - 1

    # Free slots in ascending index order; candidate k goes to the k-th.
    free_slots = torch.argsort(survivors.to(torch.int8), stable=True)
    placed = flat_valid & (cand_rank < n_free)
    target = torch.where(placed, free_slots[cand_rank.clamp(0, cap - 1)], cap)

    def candidates(name, v):
        if name == "means":
            return torch.stack([torch.where(split_mask[:, None], split_means[0], v),
                                split_means[1]])
        if name == "scales":
            return torch.stack([torch.where(split_mask[:, None], split_scales, v),
                                split_scales])
        return torch.stack([v, v])

    dead = ~survivors
    for name in PARAM_FIELDS:
        v = getattr(params, name)
        # Freed slots get dead-slot sentinels first, so an unused one stays
        # invisible; row `cap` catches the dropped candidates.
        out = torch.cat([_dead_fill(name, v, dead), v[:1]])
        out[target] = candidates(name, v).reshape((2 * cap,) + tuple(v.shape[1:]))
        v.copy_(out[:cap])
    new_alive = torch.cat([survivors, survivors.new_zeros(1)])
    new_alive[target] = placed
    new_alive = new_alive[:cap]
    _keep_moments(opt_state, survivors)

    stats["num_live"] = int(new_alive.sum())
    new_state = dataclasses.replace(state, alive=new_alive,
                                    means_grad_accum=torch.zeros_like(state.means_grad_accum))
    return new_state, opt_state, stats


@torch.no_grad()
def prune_by_mask(state: GaussianState, opt_state, prune_mask: torch.Tensor):
    """Kill the masked splats (dead-slot sentinels) and zero their Adam
    moments, in place. Returns (state, opt_state)."""
    survivors = state.alive & ~prune_mask
    for name, v in state.params.fields():
        v.copy_(_dead_fill(name, v, ~survivors))
    _keep_moments(opt_state, survivors)
    new_state = dataclasses.replace(
        state, alive=survivors,
        means_grad_accum=torch.where(survivors, state.means_grad_accum, 0.0))
    return new_state, opt_state


@torch.no_grad()
def reset_opacities(state: GaussianState, epsilon_alpha: float = 0.005, opt_state=None):
    """Periodic opacity reset: clamp live opacities to at most
    2 * epsilon_alpha in probability space (gsplat's reset value, above the
    prune floor), in place, and zero the opacity Adam moments where the
    clamp fired.

    Returns state, or (state, opt_state) when opt_state is given.
    """
    p = min(2.0 * epsilon_alpha, 0.99)
    target_logit = float(math.log(p / (1.0 - p)))
    op = state.params.opacities
    clamped = torch.where(state.alive[:, None], torch.clamp(op, max=target_logit), op)
    was_reset = clamped < op
    op.copy_(clamped)
    if opt_state is None:
        return state
    for name, m, v in opt_state.moment_pairs():
        if name == "opacities":
            m.masked_fill_(was_reset, 0.0)
            v.masked_fill_(was_reset, 0.0)
    return state, opt_state
