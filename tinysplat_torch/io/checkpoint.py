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

Sharded checkpoints (``save_checkpoint_sharded``), the JAX package's
directory layout, so either package restores the other's: every rank
writes only its rows of each leaf, and a replicated leaf is written once::

    ckpt_dir/manifest.npz                  (rank 0: leaf shapes, dtypes, meta)
    ckpt_dir/p{rank}/{state|opt}{leaf}.s{n}.npy      one piece of a leaf
    ckpt_dir/p{rank}/{state|opt}{leaf}.s{n}.idx.npy  (ndim, 2) start / stop

The leaves are those of ``state/<i>`` / ``opt/<i>`` above.
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
    state = _state_from_leaves(leaves, dev)
    opt_state = None
    if opt is not None:
        n = len(PARAM_FIELDS)
        opt_state = optimizer_with_moments(
            cfg, state.params, dict(zip(PARAM_FIELDS, opt[1:1 + n])),
            dict(zip(PARAM_FIELDS, opt[1 + n:1 + 2 * n])), int(opt[0]))
    return state, opt_state, step, rng_state


def _state_from_leaves(leaves: Dict[str, np.ndarray], dev) -> GaussianState:
    params = GaussianParams(**{
        name: torch.tensor(np.asarray(leaves[name], np.float32), device=dev)
        for name in PARAM_FIELDS})
    return GaussianState(
        params=params,
        alive=torch.tensor(np.asarray(leaves["alive"], bool), device=dev),
        means_grad_accum=torch.tensor(np.asarray(leaves["means_grad_accum"], np.float32),
                                      device=dev),
        active_sh_degree=torch.tensor(int(leaves["active_sh_degree"]), dtype=torch.int32,
                                      device=dev))


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def save_checkpoint_sharded(ckpt_dir: str, state: GaussianState, opt_state=None,
                            step: int = 0, rng_state: Optional[torch.Tensor] = None,
                            extras: Optional[dict] = None, mesh=None) -> None:
    """Write this rank's shard of ``state`` / ``opt_state`` (``mesh``'s
    rows of the capacity, ``parallel.shard_state``) into ``ckpt_dir``; every
    rank of the mesh calls it together (a shared file system is assumed).

    Crash safety as in the JAX package: everything goes to
    ``ckpt_dir/.staging`` first and is swapped in after every rank is done,
    the manifest moved last, so reusing a directory never destroys the
    previous checkpoint before the new one exists, and a restore of a half
    swapped directory fails its coverage check. ``extras`` ({name: small
    array}, replicated) go into the manifest
    (``load_checkpoint_sharded_extras``). Without a mesh the state is
    whole (one rank)."""
    import glob
    import shutil

    rank, size = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    sdir = os.path.join(ckpt_dir, ".staging")
    pdir = os.path.join(sdir, f"p{rank}")
    if rank == 0:
        shutil.rmtree(sdir, ignore_errors=True)  # stale staging of a crashed save
        os.makedirs(sdir, exist_ok=True)
    _barrier()  # writers must not race the cleanup
    os.makedirs(pdir, exist_ok=True)

    shard = state.capacity
    trees = {"state": state_leaves(state)}
    if opt_state is not None:
        trees["opt"] = opt_leaves(opt_state)
    meta = {"meta/step": np.int64(step), "meta/capacity": np.int64(shard * size),
            "meta/nprocs": np.int64(size), "meta/has_opt": np.bool_(opt_state is not None)}
    meta.update({f"extra/{k}": _numpy(v) for k, v in (extras or {}).items()})
    if rng_state is not None:
        meta["meta/torch_rng"] = _numpy(rng_state).astype(np.uint8)
    for prefix, leaves in trees.items():
        meta[f"meta/n_{prefix}"] = np.int64(len(leaves))
        for i, leaf in enumerate(leaves):
            leaf = np.asarray(leaf)
            sharded = leaf.ndim >= 1
            shape = ((shard * size,) + leaf.shape[1:]) if sharded else leaf.shape
            meta[f"shape/{prefix}/{i}"] = np.asarray(shape, np.int64)
            meta[f"dtype/{prefix}/{i}"] = np.str_(leaf.dtype.str)
            if not sharded and rank != 0:
                continue  # a replicated leaf: rank 0's copy
            bounds = np.asarray([[0, d] for d in shape], np.int64).reshape(len(shape), 2)
            if sharded:
                bounds[0] = [rank * shard, (rank + 1) * shard]
            base = os.path.join(pdir, f"{prefix}{i}.s0")
            np.save(base + ".npy", leaf)
            np.save(base + ".idx.npy", bounds)
    # Every shard file exists before rank 0 publishes the manifest, and no
    # rank returns (and, say, restores) before it is there.
    _barrier()
    if rank == 0:
        tmp = os.path.join(sdir, "manifest.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **meta)
        os.replace(tmp, os.path.join(sdir, "manifest.npz"))
        # Shard directories of an earlier save (maybe of another mesh) go;
        # the new ones move up, the manifest last.
        for d in glob.glob(os.path.join(ckpt_dir, "p*")):
            shutil.rmtree(d, ignore_errors=True)
        for entry in sorted(os.listdir(sdir)):
            if entry.startswith("p"):
                os.replace(os.path.join(sdir, entry), os.path.join(ckpt_dir, entry))
        os.replace(os.path.join(sdir, "manifest.npz"), os.path.join(ckpt_dir, "manifest.npz"))
        shutil.rmtree(sdir, ignore_errors=True)
    _barrier()


def restore_checkpoint_sharded(ckpt_dir: str, cfg: Config, mesh=None, device="cuda"
                               ) -> Tuple[GaussianState, object, int, Optional[torch.Tensor]]:
    """(state, opt_state, step, rng_state): this rank's shard of a sharded
    checkpoint of either package, for ``mesh`` (whole without one), on
    ``device``. Each leaf's rows are assembled from the saved pieces that
    intersect them (memory-mapped reads), so the saving and restoring meshes
    may differ. Raises when the pieces do not cover a leaf (missing or stale
    shard files) or the leaf counts differ from this build's."""
    import glob

    from ..train import optimizer_with_moments

    dev = resolve_device(device)
    man = np.load(os.path.join(ckpt_dir, "manifest.npz"))
    step = int(man["meta/step"])
    capacity = int(man["meta/capacity"])
    rng_state = (torch.from_numpy(man["meta/torch_rng"].astype(np.uint8))
                 if "meta/torch_rng" in man.files else None)
    if mesh is None:
        lo, hi = 0, capacity
    else:
        from ..parallel.sharding import shard_rows

        lo, hi = shard_rows(mesh, capacity)
    pieces: dict = {}
    for idx_path in glob.glob(os.path.join(ckpt_dir, "p*", "*.idx.npy")):
        name = os.path.basename(idx_path).split(".")[0]  # e.g. "state3"
        pieces.setdefault(name, []).append((np.load(idx_path),
                                            idx_path[:-len(".idx.npy")] + ".npy"))

    def assemble(prefix: str, i: int) -> np.ndarray:
        shape = tuple(man[f"shape/{prefix}/{i}"].tolist())
        dtype = np.dtype(str(man[f"dtype/{prefix}/{i}"]))
        covered = sum(int(np.prod([int(b1) - int(b0) for b0, b1 in bounds]))
                      for bounds, _ in pieces.get(f"{prefix}{i}", ()))
        if covered != int(np.prod(shape)):
            raise ValueError(
                f"sharded checkpoint leaf {prefix}/{i} is incomplete: saved pieces cover "
                f"{covered} of {int(np.prod(shape))} elements (missing or stale p*/ shard "
                f"files in {ckpt_dir})")
        starts = [lo if k == 0 else 0 for k in range(len(shape))]
        stops = [hi if k == 0 else d for k, d in enumerate(shape)]
        out = np.empty([b - a for a, b in zip(starts, stops)], dtype)
        for bounds, path in pieces.get(f"{prefix}{i}", ()):
            a = [max(s, int(b0)) for s, (b0, _) in zip(starts, bounds)]
            b = [min(e, int(b1)) for e, (_, b1) in zip(stops, bounds)]
            if any(x >= y for x, y in zip(a, b)):
                continue
            src = np.load(path, mmap_mode="r")
            src_sl = tuple(slice(x - int(b0), y - int(b0)) for x, y, (b0, _) in zip(a, b, bounds))
            out[tuple(slice(x - s0, y - s0) for x, y, s0 in zip(a, b, starts))] = src[src_sl]
        return out

    for prefix, want in (("state", len(STATE_LEAVES)), ("opt", N_OPT_LEAVES)):
        key = f"meta/n_{prefix}"
        if key in man.files and int(man[key]) != want:
            raise ValueError(f"checkpoint {prefix} tree has {int(man[key])} leaves, this "
                             f"build expects {want}: incompatible versions or config")
    state = _state_from_leaves({name: assemble("state", i)
                                for i, name in enumerate(STATE_LEAVES)}, dev)
    opt_state = None
    if bool(man["meta/has_opt"]):
        opt = [assemble("opt", i) for i in range(N_OPT_LEAVES)]
        n = len(PARAM_FIELDS)
        opt_state = optimizer_with_moments(
            cfg, state.params, dict(zip(PARAM_FIELDS, opt[1:1 + n])),
            dict(zip(PARAM_FIELDS, opt[1 + n:1 + 2 * n])), int(opt[0]))
    return state, opt_state, step, rng_state


def load_checkpoint_sharded_extras(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """The ``extras`` dict passed to ``save_checkpoint_sharded`` (may be {})."""
    with np.load(os.path.join(ckpt_dir, "manifest.npz")) as man:
        return {k.split("/", 1)[1]: np.asarray(man[k]) for k in man.files
                if k.startswith("extra/")}


def load_checkpoint_extras(path: str) -> Dict[str, np.ndarray]:
    """The ``extras`` dict passed to ``save_checkpoint`` (empty if none)."""
    with np.load(path) as z:
        return {k.split("/", 1)[1]: np.asarray(z[k]) for k in z.files
                if k.startswith("extra/")}
