"""Training checkpoints in the JAX package's ``.npz`` layout.

A checkpoint written by either package's ``save_checkpoint`` loads in the
other. One ``.npz`` holds:

- ``model/<field>``: the compact live-splat snapshot (``state_dict``), which
  ``load_model`` serves from;
- ``state/<i>``: the fixed-capacity training state in the JAX
  ``GaussianState`` leaf order: the six ``GaussianParams`` fields (means,
  colors_dc, colors_rest, scales, quats, opacities), then ``alive`` (bool),
  ``means_grad_accum`` (f32) and ``active_sh_degree`` (int32, 0-d);
- ``opt/<i>``: the optax chain's leaf order, ``scale_by_adam``'s state
  (count int32, then the six first moments, then the six second moments)
  and then the schedule state's count (int32). Both counts are the number
  of Adam updates; torch keeps it as a float ``step`` tensor;
- ``meta/step``, ``meta/capacity`` (int64) and ``extra/<name>`` (the
  ``pose_opt`` / ``app_opt`` tables and their Adam moments).

RNG: the JAX package's ``meta/rng`` holds a JAX key, which a
``torch.Generator`` cannot continue. The port keeps its generator state
under ``meta/torch_rng`` and ignores ``meta/rng`` on load; the JAX
package's ``load_checkpoint`` finds no ``meta/rng`` in a port checkpoint,
and its ``Trainer`` then starts from ``PRNGKey(cfg.seed)``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.gaussians import (
    PARAM_FIELDS,
    GaussianParams,
    GaussianState,
    from_state_dict,
    state_dict,
)
from ..utils.device import resolve_device

STATE_LEAVES = PARAM_FIELDS + ("alive", "means_grad_accum", "active_sh_degree")
# opt/<i>: scale_by_adam's count, mu (6 fields), nu (6 fields); schedule count.
N_OPT_LEAVES = 2 + 2 * len(PARAM_FIELDS)


def load_model(path: str, capacity: Optional[int] = None, device="cuda") -> GaussianState:
    """Model-only load: the ``model/*`` keys of a checkpoint, padded to
    ``capacity`` (default: next power of two >= 2N) on ``device``."""
    with np.load(path) as z:
        sd = {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("model/")}
    if "means" not in sd:
        raise ValueError(f"{path} holds no model/* arrays")
    return from_state_dict(sd, capacity=capacity, device=device)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def state_leaves(state: GaussianState) -> List[np.ndarray]:
    """The JAX ``GaussianState`` leaves of ``state``, as numpy, in order."""
    out = [_numpy(getattr(state.params, name)) for name in PARAM_FIELDS]
    out.append(_numpy(state.alive).astype(bool))
    out.append(_numpy(state.means_grad_accum).astype(np.float32))
    out.append(np.asarray(int(state.active_sh_degree), np.int32))
    return out


def opt_leaves(opt_state) -> List[np.ndarray]:
    """The optax chain leaves of a ``GaussianAdam``, as numpy, in order."""
    mu, nu, count = opt_state.moments()
    cnt = np.asarray(count, np.int32)
    return ([cnt] + [_numpy(mu[k]) for k in PARAM_FIELDS]
            + [_numpy(nu[k]) for k in PARAM_FIELDS] + [cnt])


def save_checkpoint(path: str, state: GaussianState, opt_state=None, step: int = 0,
                    rng_state: Optional[torch.Tensor] = None,
                    extras: Optional[dict] = None) -> None:
    """Write ``state``, the optimizer (a ``GaussianAdam``), ``step``, the
    generator state (``torch.Generator.get_state()``) and ``extras``
    ({name: array}) to ``path`` (atomically: a temporary file, renamed)."""
    payload = {f"extra/{k}": _numpy(v) for k, v in (extras or {}).items()}
    for k, v in state_dict(state).items():
        payload[f"model/{k}"] = v
    for i, leaf in enumerate(state_leaves(state)):
        payload[f"state/{i}"] = leaf
    if opt_state is not None:
        for i, leaf in enumerate(opt_leaves(opt_state)):
            payload[f"opt/{i}"] = leaf
    payload["meta/step"] = np.int64(step)
    payload["meta/capacity"] = np.int64(state.capacity)
    if rng_state is not None:
        payload["meta/torch_rng"] = _numpy(rng_state).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, cfg: Config, device="cuda"
                    ) -> Tuple[GaussianState, object, int, Optional[torch.Tensor]]:
    """Full-resume load: (state, opt_state, step, rng_state) on ``device``.

    ``opt_state`` is a ``GaussianAdam`` of the state's parameters with the
    saved moments and count (None if the file holds none); ``rng_state`` is
    a generator state for ``torch.Generator.set_state`` (None in a JAX
    package checkpoint).
    """
    from ..train import optimizer_with_moments

    dev = resolve_device(device)
    with np.load(path) as z:
        files = set(z.files)
        step = int(z["meta/step"])
        leaves = {name: z[f"state/{i}"] for i, name in enumerate(STATE_LEAVES)}
        opt = [z[f"opt/{i}"] for i in range(N_OPT_LEAVES)] if "opt/0" in files else None
        rng_state = (torch.from_numpy(z["meta/torch_rng"].astype(np.uint8))
                     if "meta/torch_rng" in files else None)
    params = GaussianParams(**{
        name: torch.tensor(np.asarray(leaves[name], np.float32), device=dev)
        for name in PARAM_FIELDS})
    state = GaussianState(
        params=params,
        alive=torch.tensor(np.asarray(leaves["alive"], bool), device=dev),
        means_grad_accum=torch.tensor(np.asarray(leaves["means_grad_accum"], np.float32),
                                      device=dev),
        active_sh_degree=torch.tensor(int(leaves["active_sh_degree"]), dtype=torch.int32,
                                      device=dev))
    opt_state = None
    if opt is not None:
        n = len(PARAM_FIELDS)
        opt_state = optimizer_with_moments(
            cfg, params, dict(zip(PARAM_FIELDS, opt[1:1 + n])),
            dict(zip(PARAM_FIELDS, opt[1 + n:1 + 2 * n])), int(opt[0]))
    return state, opt_state, step, rng_state


def load_checkpoint_extras(path: str) -> Dict[str, np.ndarray]:
    """The ``extras`` dict passed to ``save_checkpoint`` (empty if none)."""
    with np.load(path) as z:
        return {k.split("/", 1)[1]: np.asarray(z[k]) for k in z.files
                if k.startswith("extra/")}
