"""Port ``parallel`` (torch.distributed, gloo ranks on the CPU) vs the JAX
package's sharded step on the same mesh of virtual CPU devices.

Inputs are the JAX suite's (tests/test_parallel.py: H = W = 64, 160 splats
in 512 slots, B = 2 cameras, SH degree 2), made from numpy seeds; the JAX
draws (each step's random background, the MCMC noise, the density probe)
are computed here and handed to the ranks. The ranks run only
``tinysplat_torch`` (tests/_torch_ranks.py), through ``parallel.local.run``:
one process per rank, a ``file://`` store under a temporary directory, a
timeout on every join.

The bar is the JAX suite's 1-vs-N bar (tests/test_parallel.py:104-125):
metrics within rtol 2e-4, atol 2e-5 (the pose / app gradients rtol 2e-3,
atol 1e-6, as there); post-Adam parameters 99% within rtol 3e-4, atol
3e-5, and no element off by 2.5 x its learning rate; the densify
accumulator within rtol 5e-3, atol 1e-4. The port's bands use 16-px wide
tiles here (``tile_x=16``), as the JAX 'tiled' rasterizer does, so the
binning counters agree exactly. Renders: 2e-5, the JAX test's tolerance.
The mesh trainer is held to tests/test_torch_port_trainer.py's tolerances.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.io.checkpoint import restore_checkpoint_sharded as jax_restore
from tinysplat_tpu.io.checkpoint import save_checkpoint_sharded as jax_save
from tinysplat_tpu.parallel import make_mesh as jax_mesh
from tinysplat_tpu.parallel import make_sharded_train_step as jax_step
from tinysplat_tpu.parallel import shard_state as jax_shard
from tinysplat_tpu.regularizers.density import make_density_probe as jax_probe
from tinysplat_tpu.render import render as jax_render
from tinysplat_tpu.train import _resolve_background, init_opt_state as jax_init_opt
from tinysplat_tpu.train_loop import Trainer as JaxTrainer

import tinysplat_torch as tt
from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.io.checkpoint import load_checkpoint_sharded_extras, restore_checkpoint_sharded
from tinysplat_torch.models.gaussians import PARAM_FIELDS
from tinysplat_torch.ops.ssim import ssim
from tinysplat_torch.parallel import local
from tinysplat_torch.regularizers.density import DensityProbe
from tinysplat_torch.train import lr_tree

from tests import _torch_ranks as ranks
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_parallel import B, CAP, H, N, W, _setup
from tests.test_torch_port_trainer import PARITY, jax_start, leaves_of, port_scene
from tests.test_train_loop import _toy_scene as jax_toy_scene

STEPS = 2
LRS = {"means": 0.00016, "scales": 0.005, "quats": 0.001, "opacities": 0.05,
       "colors_dc": 0.0025}
BASE = dict(sh_degree=2, regularize_opacity=True, regularize_opacity_start=0,
            regularize_opacity_end=10, regularize_depth=True, regularize_depth_start=0,
            regularize_depth_end=10, warmup_grad=0)
# name: (mesh, config, half the splats dimmed for the MCMC noise, density probe)
CASES = {
    "interleaved": ((1, 2), dict(band_interleave=True, antialiased=True), False, False),
    "contiguous": ((1, 2), dict(band_interleave=False, regularize_density=True,
                                regularize_density_start=0, regularize_density_end=10),
                   False, True),
    "mesh_2x2": ((2, 2), dict(densify_strategy="mcmc", pose_opt=True, app_opt=True),
                 True, False),
}


def _run_ranks(fn, world, *args):
    return local.run(fn, world, args=args, device="cpu", timeout=300)


def _leaves(state):
    d = {k: np.asarray(getattr(state.params, k)) for k in PARAM_FIELDS}
    d.update(alive=np.asarray(state.alive), active_sh_degree=int(state.active_sh_degree))
    return d


def _concat(shards, key):
    return {k: np.concatenate([s[key][k] for s in shards]) for k in shards[0][key]}


@functools.cache
def _inputs(case):
    """The case's JAX inputs, draws and the JAX sharded step's result."""
    shape, extra, dimmed, density = CASES[case]
    state, cam_batch, gt, est = _setup()
    if dimmed:
        # Open the MCMC noise gate (tests/test_parallel.py:184-194) of every
        # other live splat; the rest stay visible, so the poses have a
        # gradient.
        dim = state.alive & (jnp.arange(CAP) % 2 == 0)
        state = dataclasses.replace(state, params=dataclasses.replace(
            state.params, opacities=jnp.where(dim[:, None], -7.0, state.params.opacities)))
    cfg = JaxConfig(rasterizer="tiled", **BASE, **extra)
    pose = app = probe = None
    kw = {}
    if cfg.pose_opt:
        pose = np.asarray([[0.01, -0.02, 0.005, 0.01, 0.0, -0.01],
                           [-0.005, 0.01, 0.02, 0.0, 0.01, 0.005]], np.float32)
        app = (0.05 * np.random.default_rng(9).normal(size=(B, 12))).astype(np.float32)
        kw = dict(pose_deltas=jnp.asarray(pose), app_params=jnp.asarray(app))
    mesh = jax_mesh(*shape)
    if density:
        from jax.sharding import NamedSharding, PartitionSpec

        probe = jax_probe(state.params, state.alive, jax.random.PRNGKey(5), num_samples=2048)
        kw["density_probe"] = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, PartitionSpec("tile"))), probe)
    keys = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
    backgrounds = [np.asarray(_resolve_background(cfg, k)) for k in keys]
    noise = ([np.asarray(jax.random.normal(jax.random.fold_in(k, 1), (CAP, 3)))
              for k in keys] if cfg.densify_strategy == "mcmc" else None)
    st = jax.tree.map(jnp.copy, state)
    op = jax_init_opt(cfg, st)
    st, op = jax_shard(mesh, st), jax_shard(mesh, op)
    fn = jax_step(cfg, H, W, B, mesh, use_depth=True, use_density=density)
    for i, k in enumerate(keys):
        out = fn(st, op, cam_batch, gt, est, i, k, **kw)
        st, op = out.state, out.opt_state
    port_probe = None if probe is None else DensityProbe(
        torch.tensor(np.asarray(probe.points)), torch.tensor(np.asarray(probe.knn_idx)).long(),
        torch.tensor(np.asarray(probe.beta)))
    return dict(shape=shape, extra=extra, state=state, gt=np.asarray(gt), est=np.asarray(est),
                backgrounds=backgrounds, noise=noise, pose=pose, app=app, probe=port_probe,
                ref_state=jax.device_get(out.state), ref_metrics=jax.device_get(out.metrics))


def test_banded_render_matches_jax_band():
    """render(row_stride=2, row_offset=o, proj_height=H) renders the
    interleaved band of tile rows {o, o + 2} as the JAX 'tiled' band does,
    and the two bands are the rows of the whole frame."""
    state, cam_batch, _, _ = _setup()
    jcam = jax.tree.map(lambda x: x[0], cam_batch)
    cam = orbit_cameras(B, width=W, height=H)[0].params(device="cpu")
    ts = tt.from_jax_params(_leaves(state), "cpu")
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    whole, _ = tt.render(ts.params, ts.alive, cam, H, W, 2, torch.as_tensor(bg), tile_x=16)
    for offset in (0, 1):
        rgb, ex = tt.render(ts.params, ts.alive, cam, H // 2, W, 2, torch.as_tensor(bg),
                            tile_x=16, row_stride=2, row_offset=offset, proj_height=H)
        ref, rex = jax_render(state.params, state.alive, jcam, H // 2, W, jnp.int32(2),
                              jnp.asarray(bg), rasterizer="tiled", row_stride=2,
                              row_offset=offset, proj_height=H)
        np.testing.assert_allclose(rgb.numpy(), np.asarray(ref), atol=2e-5)
        np.testing.assert_allclose(ex["alpha"].numpy(), np.asarray(rex["alpha"]), atol=2e-5)
        np.testing.assert_allclose(ex["depth"].numpy(), np.asarray(rex["depth"]), atol=2e-5,
                                   rtol=2e-5)
        assert ex["binning"]["intersections"] == int(rex["binning"]["intersections"])
        rows = (np.arange(2)[:, None] * 2 + offset) * 16 + np.arange(16)
        np.testing.assert_allclose(rgb.numpy(), whole.numpy()[rows.reshape(-1)], atol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax_mesh(case):
    c = _inputs(case)
    shape = c["shape"]
    cams = [cam.params(device="cpu") for cam in orbit_cameras(B, width=W, height=H)]
    shards = _run_ranks(ranks.sharded_steps, shape[0] * shape[1], shape,
                        dict(BASE, tile_x=16, **c["extra"]), _leaves(c["state"]), cams,
                        c["gt"], c["est"], c["backgrounds"], c["noise"], c["pose"], c["app"],
                        c["probe"])
    m, ref_m = shards[0]["metrics"], c["ref_metrics"]
    for s in shards[1:]:  # the metrics are replicated
        for k, v in s["metrics"].items():
            np.testing.assert_array_equal(v, m[k], err_msg=k)
    assert set(m) == set(ref_m)
    for k in ref_m:
        tol = dict(rtol=2e-3, atol=1e-6) if k in ("pose_grad", "app_grad") else dict(
            rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(m[k], np.asarray(ref_m[k]), err_msg=k, **tol)
    if "pose_grad" in m:
        assert np.abs(m["pose_grad"]).sum() > 0 and np.abs(m["app_grad"]).sum() > 0
    if case == "contiguous":
        assert m["loss_density"] > 0
    params = _concat(shards, "params")
    ref = c["ref_state"]
    for name, lr in LRS.items():
        a = np.asarray(getattr(ref.params, name))[:N]
        b = params[name][:N]
        close = np.isclose(a, b, rtol=3e-4, atol=3e-5)
        assert close.mean() > 0.99, f"{name}: {(~close).sum()}/{close.size} differ"
        assert np.max(np.abs(a - b)) < 2.5 * lr, name
    if case == "mesh_2x2":  # the noise moved the means: the shard rows of one draw
        moved = np.abs(params["means"][:N] - np.asarray(c["state"].params.means)[:N]).max()
        assert moved > 0
    accum = np.concatenate([s["accum"] for s in shards])
    np.testing.assert_allclose(accum[:N], np.asarray(ref.means_grad_accum)[:N], rtol=5e-3,
                               atol=1e-4)


def test_clone_ties_do_not_depend_on_the_mesh():
    """Every live splat cloned exactly (as a densify clone is): binning
    breaks the exact depth ties by position, so the (2, 2) mesh puts the
    gathered attributes back in global order, and its steps equal the
    one-rank mesh's slot by slot at the 1-vs-N bar."""
    state, _, gt, est = _setup()
    leaves = {k: np.array(v) for k, v in _leaves(state).items()}
    for k in PARAM_FIELDS:
        leaves[k][N:2 * N] = leaves[k][:N]
    leaves["alive"][N:2 * N] = True
    cams = [cam.params(device="cpu") for cam in orbit_cameras(B, width=W, height=H)]
    args = (dict(BASE, tile_x=16), leaves, cams, np.asarray(gt), np.asarray(est),
            [np.asarray([0.1, 0.2, 0.3], np.float32)] * STEPS)
    one = ranks.sharded_steps((1, 1), *args)
    mesh = _run_ranks(ranks.sharded_steps, 4, (2, 2), *args)
    params = _concat(mesh, "params")
    for name, lr in LRS.items():
        a, b = one["params"][name][:2 * N], params[name][:2 * N]
        assert np.isclose(a, b, rtol=3e-4, atol=3e-5).mean() > 0.99, name
        assert np.max(np.abs(a - b)) < 2.5 * lr, name
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(mesh[0]["metrics"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)


def test_sharded_render_interleaved_matches_unsharded():
    """Two ranks, each a band of tile rows {r, r + 2} (interleaved), the
    bands gathered and put back in order: the one-device frame."""
    state, _, _, _ = _setup()
    cam = orbit_cameras(B, width=W, height=H)[0].params(device="cpu")
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    ts = tt.from_jax_params(_leaves(state), "cpu")
    rgb, ex = tt.render(ts.params, ts.alive, cam, H, W, 2, torch.as_tensor(bg), tile_x=16)
    out = _run_ranks(ranks.sharded_render, 2, (1, 2), dict(sh_degree=2, tile_x=16),
                     _leaves(state), cam, H, W, bg)
    for got in out:
        np.testing.assert_allclose(got[0], rgb.numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[1], ex["depth"].numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[2], ex["alpha"].numpy(), rtol=2e-5, atol=2e-5)


def test_distributed_ssim_value_and_gradient():
    """The mesh's SSIM (halo'd bands, interleaved and contiguous) equals the
    one-device mean SSIM, and its gradient does too: the halo's gradient
    returns to the band that owns the rows, through the inverse
    permutation (and the roll of the last interleaved band)."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (B, H, 48, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    xt = torch.as_tensor(x).clone().requires_grad_()
    ref = torch.stack([ssim(xt[b], torch.as_tensor(y[b])) for b in range(B)]).mean()
    ref.backward()
    out = _run_ranks(ranks.ssim_value_and_grad, 4, (2, 2), x, y)
    for mode in range(2):
        grad = np.zeros_like(x)
        for rank in out:
            value, g, rows, (b0, b1) = rank[mode]
            np.testing.assert_allclose(value, float(ref.detach()), rtol=1e-6)
            grad[b0:b1][:, rows] = g
        scale = np.abs(xt.grad.numpy()).max()
        np.testing.assert_allclose(grad, xt.grad.numpy(), atol=1e-5 * scale)


MESH_SIZE = 64  # the band height must split into 2 bands of whole 16-px rows


@functools.cache
def _jax_trainer_run():
    jtr = JaxTrainer(JaxConfig(**PARITY), jax_toy_scene(n_cams=4, size=MESH_SIZE),
                     jax_start())
    jtr.run(8)
    adam = jtr.opt_state[0]
    return {"capacity": jtr.state.capacity, "alive": np.asarray(jtr.state.alive),
            "count": int(adam.count),
            "params": {k: np.asarray(getattr(jtr.state.params, k)) for k in PARAM_FIELDS},
            "mu": {k: np.asarray(getattr(adam.mu, k)) for k in PARAM_FIELDS},
            "nu": {k: np.asarray(getattr(adam.nu, k)) for k in PARAM_FIELDS},
            "accum": np.asarray(jtr.state.means_grad_accum)}


def test_mesh_trainer_matches_jax_trainer():
    """MeshTrainer on mesh (1, 2), 8 steps (densify at 4 and 8, each
    overflowing and growing the capacity, which re-shards; the opacity
    reset at 6) against the JAX one-device Trainer on the same cameras."""
    ref = _jax_trainer_run()
    kw = dict(PARITY, rasterizer="auto")
    out = _run_ranks(ranks.mesh_trainer_run, 2, (1, 2), kw, leaves_of(jax_start()),
                     port_scene(jax_toy_scene(n_cams=4, size=MESH_SIZE)), 8)
    assert [h["capacity_after"] for h in out[0]["history"]] == [128, 256]
    assert out[0]["capacity"] == ref["capacity"] == 256
    assert out[0]["count"] == ref["count"] == 8 and out[0]["step"] == 8
    np.testing.assert_array_equal(np.concatenate([s["alive"] for s in out]), ref["alive"])
    params, mu, nu = _concat(out, "params"), _concat(out, "mu"), _concat(out, "nu")
    lrs = lr_tree(tt.Config(**kw))

    def close_to_max(got, want, rel, name):
        np.testing.assert_allclose(got, want, atol=rel * max(float(np.abs(want).max()), 1e-12),
                                   rtol=0, err_msg=name)

    for name in PARAM_FIELDS:
        got, want, g_ref = params[name], ref["params"][name], ref["mu"][name]
        k = 5.0 if name == "quats" else 1.0
        diff = np.abs(got - want)
        clear = np.abs(g_ref) >= 1e-3 * np.abs(g_ref).max()
        assert diff[clear].max() <= k * 2e-4 * np.abs(want).max() + 1e-6, name
        assert diff.max() <= 1e-6 + 16 * lrs[name], name
        close_to_max(mu[name], ref["mu"][name], k * 2e-4, f"mu {name}")
        close_to_max(nu[name], ref["nu"][name], k * 5e-4, f"nu {name}")
    close_to_max(np.concatenate([s["accum"] for s in out]), ref["accum"], 2e-4, "accum")


def test_sharded_checkpoints_cross_packages(tmp_path):
    """The JAX package's (2, 2) sharded checkpoint restores in 4 port ranks,
    which write it again; the JAX package restores that onto its (2, 2)
    mesh, and one port rank restores it whole: every leaf equal."""
    c = _inputs("interleaved")
    cfg = JaxConfig(rasterizer="tiled", **BASE)
    mesh = jax_mesh(2, 2)
    state = jax.tree.map(jnp.copy, c["state"])
    _, cam_batch, gt, est = _setup()
    st, op = jax_shard(mesh, state), jax_shard(mesh, jax_init_opt(cfg, state))
    out = jax_step(cfg, H, W, B, mesh, use_depth=True)(st, op, cam_batch, gt, est, 0,
                                                      jax.random.PRNGKey(3))
    extras = {"pose_deltas": np.arange(12, dtype=np.float32).reshape(2, 6)}
    jdir, pdir = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_save(jdir, out.state, out.opt_state, 1, jax.random.PRNGKey(0), extras=extras)
    ref_state, ref_opt = jax.device_get(out.state), jax.device_get(out.opt_state)
    shards = _run_ranks(ranks.sharded_checkpoint_roundtrip, 4, (2, 2), jdir, pdir,
                        dict(BASE))
    params = _concat(shards, "params")
    for name in PARAM_FIELDS:
        np.testing.assert_array_equal(params[name], np.asarray(getattr(ref_state.params, name)))
        np.testing.assert_array_equal(_concat(shards, "mu")[name],
                                      np.asarray(getattr(ref_opt[0].mu, name)))
    np.testing.assert_array_equal(np.concatenate([s["alive"] for s in shards]),
                                  np.asarray(ref_state.alive))
    assert all(s["step"] == 1 and s["count"] == 1 for s in shards)
    np.testing.assert_array_equal(shards[0]["extras"]["pose_deltas"], extras["pose_deltas"])
    st2, op2, step2, key2 = jax_restore(pdir, cfg, mesh)
    assert step2 == 2 and key2 is None
    for a, b in zip(jax.tree.leaves(jax.device_get(st2)), jax.tree.leaves(ref_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(jax.device_get(op2)), jax.tree.leaves(ref_opt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    whole, opt, step, _ = restore_checkpoint_sharded(pdir, tt.Config(**BASE), device="cpu")
    np.testing.assert_array_equal(whole.params.means.detach().numpy(),
                                  np.asarray(ref_state.params.means))
    assert step == 2 and opt.count == 1
    np.testing.assert_array_equal(load_checkpoint_sharded_extras(pdir)["pose_deltas"],
                                  extras["pose_deltas"])
    os.remove(os.path.join(pdir, "p3", "state0.s0.npy"))
    os.remove(os.path.join(pdir, "p3", "state0.s0.idx.npy"))
    with pytest.raises(ValueError, match="incomplete"):
        restore_checkpoint_sharded(pdir, tt.Config(**BASE), device="cpu")


def test_cli_two_processes_write_a_sharded_checkpoint(tmp_path):
    """``train_cli --mesh-tile 2`` in 2 processes (with pose_opt): it
    finishes, writes one sharded checkpoint, and a resume from it in 2
    processes goes on from its step."""
    argv = ["--train", "--no-viewer", "--synthetic", "--device", "cpu", "--mesh-tile", "2",
            "--pose-opt", "--max-iter", "3", "--save-checkpoints", "--checkpoint-interval",
            "3", "--checkpoint-dir", str(tmp_path)]
    out = _run_ranks(ranks.cli_main, 2, argv)
    assert [r["step"] for r in out] == [3, 3]
    (ckpt,) = out[0]["files"]
    state, opt, step, rng = restore_checkpoint_sharded(str(tmp_path / ckpt), tt.Config(),
                                                       device="cpu")
    assert step == 3 and opt.count == 3 and rng is not None
    assert load_checkpoint_sharded_extras(str(tmp_path / ckpt))["pose_cnt"].sum() == 3
    resumed = _run_ranks(ranks.cli_main, 2, argv[:-7] + [
        "--max-iter", "4", "--load-checkpoint", str(tmp_path / ckpt)])
    assert [r["step"] for r in resumed] == [4, 4]


@pytest.mark.parametrize("env,init,cards,want", [
    # torchrun over 2 hosts of 8 cards: 16 ranks, each owns a card.
    (dict(RANK="9", WORLD_SIZE="16", LOCAL_RANK="1", LOCAL_WORLD_SIZE="8"), {}, 8,
     ("nccl", 1)),
    # 4 local ranks on one card (parallel.local.run): NCCL refuses them.
    (dict(LOCAL_RANK="3", LOCAL_WORLD_SIZE="4"),
     dict(init_method="file:///store", rank=3, world_size=4), 1, ("gloo", 0)),
    # --coordinator-address, no local counts: each process owns a card.
    ({}, dict(init_method="tcp://10.0.0.1:1234", rank=5, world_size=16), 8, ("nccl", 5)),
], ids=["torchrun_two_hosts", "local_ranks_share_a_card", "coordinator_address"])
def test_init_distributed_backend_from_local_counts(monkeypatch, env, init, cards, want):
    """The backend is NCCL unless the ranks of this host outnumber its
    cards, whatever the global world size; the card is the local rank's."""
    from tinysplat_torch.parallel import trainer as ptr

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("device", d))
    monkeypatch.setattr(ptr.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(ptr.dist, "init_process_group",
                        lambda backend, **kw: calls.setdefault("backend", backend))
    dev = ptr.init_distributed(device="cuda", **init)
    assert (calls["backend"], calls["device"].index) == want
    assert dev == calls["device"]


def test_init_distributed_cpu_is_gloo(monkeypatch):
    from tinysplat_torch.parallel import trainer as ptr

    calls = {}
    monkeypatch.setattr(ptr.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(ptr.dist, "init_process_group",
                        lambda backend, **kw: calls.setdefault("backend", backend))
    assert ptr.init_distributed("file:///store", 0, 2, device="cpu") == torch.device("cpu")
    assert calls["backend"] == "gloo"
