"""Rank programs of tests/test_torch_port_parallel.py.

Each function runs on every rank of a ``tinysplat_torch.parallel.local.run``
world (gloo on the CPU) and returns what the test compares. They import
only ``tinysplat_torch``, torch and numpy: the ranks never load JAX.
"""
import os

import numpy as np
import torch

from tinysplat_torch.config import Config
from tinysplat_torch.models.gaussians import PARAM_FIELDS, from_jax_params
from tinysplat_torch.parallel import (
    MeshTrainer,
    make_mesh,
    make_sharded_render,
    make_sharded_train_step,
    shard_state,
)
from tinysplat_torch.parallel.train_step import band_rows, dist_ssim
from tinysplat_torch.train import init_opt_state


def _shard_out(state, metrics=None):
    out = {"params": {k: getattr(state.params, k).detach().numpy().copy() for k in PARAM_FIELDS},
           "alive": state.alive.numpy().copy(),
           "accum": state.means_grad_accum.numpy().copy()}
    if metrics is not None:
        out["metrics"] = {k: np.asarray(v.detach() if torch.is_tensor(v) else v)
                          for k, v in metrics.items()}
    return out


def sharded_steps(mesh_shape, cfg_kw, leaves, cams, gt, est, backgrounds, noise=None,
                  pose=None, app=None, probe=None):
    """``len(backgrounds)`` sharded steps from the full state ``leaves``;
    the rank's shard and the last step's metrics."""
    cfg = Config(**cfg_kw)
    mesh = make_mesh(*mesh_shape)
    full = from_jax_params(leaves, "cpu")
    state, opt = shard_state(mesh, full, init_opt_state(cfg, full))
    B, H, W = gt.shape[:3]
    d, t = mesh.coords
    bl = B // mesh.data
    local = slice(d * bl, (d + 1) * bl)
    rows = band_rows(H, mesh.tile, t, cfg.tile_size, cfg.band_interleave and mesh.tile > 1)
    gt_band = torch.tensor(gt[local])[:, rows]
    est_band = torch.tensor(est[local])[:, rows]
    if probe is not None:
        n = probe.points.shape[0] // mesh.tile
        probe = type(probe)(*(x[t * n:(t + 1) * n] for x in probe))
    step = make_sharded_train_step(cfg, H, W, B, mesh, use_depth=True,
                                   use_density=probe is not None)
    kw = {}
    if pose is not None:
        kw["pose_deltas"] = torch.tensor(pose[local])
    if app is not None:
        kw["app_params"] = torch.tensor(app[local])
    for i, bg in enumerate(backgrounds):
        out = step(state, opt, cams[local], gt_band, est_band, i,
                   background=torch.tensor(bg),
                   noise_eps=None if noise is None else torch.tensor(noise[i]),
                   density_probe=probe, **kw)
        state, opt = out.state, out.opt_state
    return _shard_out(state, out.metrics)


def sharded_render(mesh_shape, cfg_kw, leaves, cam, H, W, bg):
    cfg = Config(**cfg_kw)
    mesh = make_mesh(*mesh_shape)
    state, _ = shard_state(mesh, from_jax_params(leaves, "cpu"))
    rgb, depth, alpha = make_sharded_render(cfg, H, W, mesh)(
        state.params, state.alive, state.active_sh_degree, cam, torch.tensor(bg))
    return rgb.numpy(), depth.numpy(), alpha.numpy()


def ssim_value_and_grad(mesh_shape, x, y):
    """The distributed SSIM of (B, H, W, 3) images x, y and its gradient
    for this rank's band of x, with interleaved and with contiguous bands:
    [(value, grad, global rows, batch slice)] in that order."""
    mesh = make_mesh(*mesh_shape)
    B, H, W = x.shape[:3]
    d, t = mesh.coords
    bl = B // mesh.data
    out = []
    for interleave in (True, False):
        rows = band_rows(H, mesh.tile, t, 16, interleave)
        xb = torch.tensor(x[d * bl:(d + 1) * bl])[:, rows].clone().requires_grad_()
        yb = torch.tensor(y[d * bl:(d + 1) * bl])[:, rows]
        s = dist_ssim(xb, yb, H, W, B, mesh, interleave, 16)
        s.backward()
        out.append((float(s), xb.grad.numpy(), rows.numpy(), (d * bl, (d + 1) * bl)))
    return out


def mesh_trainer_run(mesh_shape, cfg_kw, leaves, scene, steps):
    """``MeshTrainer`` for ``steps`` steps; the rank's shard, the Adam
    moments and the densify history."""
    cfg = Config(**cfg_kw)
    tr = MeshTrainer(cfg, scene, from_jax_params(leaves, "cpu"), mesh=make_mesh(*mesh_shape))
    tr.run(steps)
    mu, nu, count = tr.opt_state.moments()
    out = _shard_out(tr.state)
    out.update(mu={k: v.numpy().copy() for k, v in mu.items()},
               nu={k: v.numpy().copy() for k, v in nu.items()}, count=count, step=tr.step,
               history=[{k: h[k] for k in ("capacity_before", "capacity_after", "overflow")}
                        for h in tr.densify_history],
               capacity=tr._global_capacity())
    return out


def sharded_checkpoint_roundtrip(mesh_shape, ckpt_in, ckpt_out, cfg_kw):
    """Restore ``ckpt_in`` (either package's sharded layout) into this mesh,
    write it to ``ckpt_out``; the rank's restored shard."""
    from tinysplat_torch.io.checkpoint import (
        load_checkpoint_sharded_extras,
        restore_checkpoint_sharded,
        save_checkpoint_sharded,
    )

    cfg = Config(**cfg_kw)
    mesh = make_mesh(*mesh_shape)
    state, opt, step, rng = restore_checkpoint_sharded(ckpt_in, cfg, mesh, device="cpu")
    extras = load_checkpoint_sharded_extras(ckpt_in)
    save_checkpoint_sharded(ckpt_out, state, opt, step + 1, rng, extras=extras, mesh=mesh)
    mu, nu, count = opt.moments()
    out = _shard_out(state)
    out.update(mu={k: v.numpy().copy() for k, v in mu.items()}, count=count, step=step,
               extras=extras)
    return out


def cli_main(argv):
    """``train_cli.main`` on this rank; the trainer's step and checkpoint
    directory listing."""
    from tinysplat_torch import train_cli

    tr = train_cli.main(argv)
    ck = tr.cfg.checkpoint_dir
    return {"step": tr.step, "type": type(tr).__name__,
            "files": sorted(os.listdir(ck)) if os.path.isdir(ck) else []}
