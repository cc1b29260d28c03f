"""Port ``Trainer`` vs the JAX package's (``tinysplat_tpu.train_loop``), plus
the trainer's host features on the port alone.

The parity run: 4 orbit cameras at 48x48 (GT rendered by the JAX dense
oracle), 40 splats in 64 slots carried across with ``from_jax_params``,
background black, ``rasterizer="dense"`` on both sides, 8 steps. tau_means
0 makes every live splat a densify candidate and a large
``densify_scale_thresh`` makes every candidate a clone (no random draw):
the densify at step 4 overflows 64 slots (large, faint splats are pruned as
well), grows to 128 and redoes the pass, the one at step 8 grows to 256;
the opacity reset fires at step 6.

Tolerances: ``alive``, capacity, step and the Adam count exactly; every
parameter field and first moment to 2e-4 x the field's max, the second
moment to 5e-4 x max, as one step is held in test_torch_port_train.py, but
over 8 steps a near-zero gradient's sign may differ between the packages
and move a parameter by ~lr per step, so parameters also pass within
1e-6 + 16 lr of JAX (8 steps x 2 lr) where their gradient was that small.
Quats get 5x those relative bounds: the splats start isotropic, where a
rotation changes nothing, so their gradient is rounding residue (~1e-3 of
the other fields'), whose relative error is that much larger.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu import train as jt
from tinysplat_tpu.cameras import apply_pose_delta as jax_apply_pose_delta
from tinysplat_tpu.cameras import so3_exp as jax_so3_exp
from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.data.synthetic import synthetic_pcd as jax_synthetic_pcd
from tinysplat_tpu.models.gaussians import init_from_pcd as jax_init_from_pcd
from tinysplat_tpu.train_loop import Trainer as JaxTrainer

import tinysplat_torch as tt
from tinysplat_torch import train as pt
from tinysplat_torch.cameras import apply_pose_delta, so3_exp
from tinysplat_torch.config import Config
from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.io.checkpoint import load_checkpoint, load_checkpoint_extras
from tinysplat_torch.models.gaussians import PARAM_FIELDS
from tinysplat_torch.scene import Scene
from tinysplat_torch.parallel import MeshTrainer
from tinysplat_torch.train_loop import Trainer

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_train_loop import _toy_scene as jax_toy_scene

SIZE, CAMS = 48, 4
PARITY = dict(rasterizer="dense", sh_degree=1, background="black", warmup_grad=0,
              warmup_densify=4, densify_end=100, tau_means=0.0, densify_scale_thresh=1e9,
              interval_opacity_reset=6, nan_guard_interval=4, max_iter=8,
              prefetch_images=False)


def port_scene(jax_scene):
    """The port's cameras with the JAX scene's ground-truth frames."""
    size = jax_scene.cameras[0].width
    cams = orbit_cameras(len(jax_scene.cameras), width=size, height=size)
    for cam, jcam in zip(cams, jax_scene.cameras):
        cam._image = np.asarray(jcam.get_original_image()).copy()
    return Scene(cams)


def jax_start(n=40, cap=64, seed=2):
    pcd = jax_synthetic_pcd(n, seed=seed)
    return jax_init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, capacity=cap)


def leaves_of(jstate):
    d = {k: np.asarray(getattr(jstate.params, k)) for k in PARAM_FIELDS}
    d.update(alive=np.asarray(jstate.alive), active_sh_degree=int(jstate.active_sh_degree))
    return d


def port_trainer(cfg, jax_scene=None, jstate=None, **kw):
    jax_scene = jax_scene or jax_toy_scene(n_cams=CAMS, size=SIZE)
    state = tt.from_jax_params(leaves_of(jstate or jax_start()), "cpu")
    return Trainer(cfg, port_scene(jax_scene), state, **kw)


@functools.cache
def _jax_run():
    jtr = JaxTrainer(JaxConfig(**PARITY), jax_toy_scene(n_cams=CAMS, size=SIZE), jax_start())
    jtr.run(8)
    adam = jtr.opt_state[0]
    return {
        "step": jtr.step, "capacity": jtr.state.capacity,
        "alive": np.asarray(jtr.state.alive), "count": int(adam.count),
        "params": {k: np.asarray(getattr(jtr.state.params, k)) for k in PARAM_FIELDS},
        "mu": {k: np.asarray(getattr(adam.mu, k)) for k in PARAM_FIELDS},
        "nu": {k: np.asarray(getattr(adam.nu, k)) for k in PARAM_FIELDS},
        "accum": np.asarray(jtr.state.means_grad_accum),
    }


def _close_to_max(got, ref, rel, name):
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=0, err_msg=name)


def test_trainer_matches_jax_slot_by_slot():
    ref = _jax_run()
    tr = port_trainer(Config(**PARITY))
    tr.run(8)
    assert tr.step == ref["step"] == 8
    assert [h["capacity_after"] for h in tr.densify_history] == [128, 256]
    assert all(h["overflow"] > 0 and h["pruned"] > 0 for h in tr.densify_history)
    assert tr.state.capacity == ref["capacity"]
    np.testing.assert_array_equal(tr.state.alive.numpy(), ref["alive"])
    mu, nu, count = tr.opt_state.moments()
    assert count == ref["count"] == 8
    lrs = pt.lr_tree(tr.cfg)
    for name, t in tr.state.params.fields():
        got, want = t.detach().numpy(), ref["params"][name]
        g_ref = ref["mu"][name]
        k = 5.0 if name == "quats" else 1.0
        diff = np.abs(got - want)
        clear = np.abs(g_ref) >= 1e-3 * np.abs(g_ref).max()
        assert diff[clear].max() <= k * 2e-4 * np.abs(want).max() + 1e-6, name
        assert diff.max() <= 1e-6 + 16 * lrs[name], name
        _close_to_max(mu[name].numpy(), ref["mu"][name], k * 2e-4, f"mu {name}")
        _close_to_max(nu[name].numpy(), ref["nu"][name], k * 5e-4, f"nu {name}")
    _close_to_max(tr.state.means_grad_accum.numpy(), ref["accum"], 2e-4, "accum")


# -- pose and appearance optimization ------------------------------------------------


def test_so3_exp_and_apply_pose_delta_match_jax_with_jacobians():
    rng = np.random.default_rng(0)
    for w in [np.zeros(3, np.float32)] + [rng.normal(scale=0.7, size=3).astype(np.float32)
                                           for _ in range(3)]:
        np.testing.assert_allclose(so3_exp(torch.from_numpy(w)).numpy(),
                                   np.asarray(jax_so3_exp(jnp.asarray(w))), atol=1e-6)
        jac = torch.autograd.functional.jacobian(so3_exp, torch.from_numpy(w))
        np.testing.assert_allclose(jac.numpy(), np.asarray(jax.jacfwd(jax_so3_exp)(
            jnp.asarray(w))), atol=1e-5)
        assert np.isfinite(jac.numpy()).all()
    jcam = jax_orbit_cameras(3, width=32, height=32)[1].params()
    cam = orbit_cameras(3, width=32, height=32)[1].params(device="cpu")
    for delta in (np.zeros(6, np.float32),
                  np.asarray([0.05, -0.02, 0.03, 0.01, 0.02, -0.01], np.float32)):
        out = apply_pose_delta(cam, torch.from_numpy(delta))
        jout = jax_apply_pose_delta(jcam, jnp.asarray(delta))
        np.testing.assert_allclose(out.viewmat.numpy(), np.asarray(jout.viewmat), atol=1e-6)
        np.testing.assert_allclose(out.cam_pos.numpy(), np.asarray(jout.cam_pos), atol=1e-5)

        def view_of(d):
            return apply_pose_delta(cam, d).viewmat

        jac = torch.autograd.functional.jacobian(view_of, torch.from_numpy(delta))
        jjac = jax.jacfwd(lambda d: jax_apply_pose_delta(jcam, d).viewmat)(jnp.asarray(delta))
        np.testing.assert_allclose(jac.numpy(), np.asarray(jjac), atol=1e-5)


def test_apply_appearance_matches_jax():
    rng = np.random.default_rng(2)
    rgb = rng.uniform(0, 1, size=(8, 8, 3)).astype(np.float32)
    for app in (np.zeros(12, np.float32), rng.normal(scale=0.2, size=12).astype(np.float32)):
        np.testing.assert_allclose(
            pt.apply_appearance(torch.from_numpy(rgb), torch.from_numpy(app)).numpy(),
            np.asarray(jt.apply_appearance(jnp.asarray(rgb), jnp.asarray(app))), atol=1e-6)


def test_pose_and_app_gradients_match_jax():
    """One step with pose_opt + app_opt from the same state: pose_grad (6,)
    and app_grad (12,) to 5e-4 x max (as tests/test_torch_oracle.py holds
    gradients), and the splat update of the plain step."""
    jscene = jax_toy_scene(n_cams=CAMS, size=SIZE)
    jstate = jax_start()
    kw = dict(rasterizer="dense", sh_degree=1, background="black", pose_opt=True,
              app_opt=True)
    delta = np.asarray([0.01, -0.02, 0.015, 0.02, -0.01, 0.03], np.float32)
    app = (np.random.default_rng(1).normal(scale=0.05, size=12)).astype(np.float32)
    jcam = jscene.cameras[1]
    gt = np.asarray(jcam.get_original_image())
    jcfg = JaxConfig(**kw)
    out = jt.make_train_step(jcfg, SIZE, SIZE)(
        jstate, jt.init_opt_state(jcfg, jstate), jcam.params(), jnp.asarray(gt), None,
        jnp.int32(1), jax.random.PRNGKey(0), None, jnp.asarray(delta), jnp.asarray(app))
    state = tt.from_jax_params(leaves_of(jax_start()), "cpu")
    cfg = Config(**kw)
    cam = port_scene(jscene).cameras[1]
    got = tt.make_train_step(cfg, SIZE, SIZE)(
        state, tt.init_opt_state(cfg, state), cam.params("cpu"), torch.tensor(gt), None, 1,
        pose_delta=torch.from_numpy(delta), app_params=torch.from_numpy(app))
    for k in ("pose_grad", "app_grad"):
        ref = np.asarray(out.metrics[k])
        assert np.abs(ref).max() > 0
        _close_to_max(got.metrics[k].numpy(), ref, 5e-4, k)
    np.testing.assert_allclose(float(got.metrics["loss"]), float(out.metrics["loss"]),
                               rtol=1e-5)


def test_pose_app_tables_train_and_ride_checkpoints(tmp_path):
    cfg = Config(rasterizer="dense", sh_degree=1, max_iter=4, warmup_densify=10**9,
                 interval_opacity_reset=0, pose_opt=True, app_opt=True,
                 save_checkpoints=True, checkpoint_interval=4, checkpoint_dir=str(tmp_path))
    tr = port_trainer(cfg)
    tr.run(4)
    assert float(tr.pose_deltas.abs().sum()) > 0 and float(tr.app_params.abs().sum()) > 0
    assert int(tr._pose_cnt.sum()) == 4
    path = sorted(tmp_path.glob("*.npz"))[-1]
    st, opt, step, rng = load_checkpoint(str(path), cfg, device="cpu")
    tr2 = Trainer(cfg, tr.scene, st, opt, step, rng)
    tr2.restore_pose_state(load_checkpoint_extras(str(path)))
    for a, b in ((tr2.pose_deltas, tr.pose_deltas), (tr2.app_params, tr.app_params),
                 (tr2._pose_m, tr._pose_m), (tr2._app_v, tr._app_v)):
        assert torch.equal(a, b)
    # The refined pose renders; app_opt alone has no pose delta to apply.
    rgb, _ = tr2.render_camera(tr.scene.cameras[0])
    assert rgb.shape == (SIZE, SIZE, 3) and torch.isfinite(rgb).all()
    only_app = port_trainer(Config(rasterizer="dense", sh_degree=1, app_opt=True))
    assert torch.isfinite(only_app.render_camera(only_app.scene.cameras[0])[0]).all()


def test_pose_recovery_end_to_end():
    """All splat LRs zero, cameras perturbed by a known SE(3) error: only
    the pose deltas can lower the loss, and they undo most of the error."""
    jscene = jax_toy_scene(n_cams=3, size=SIZE)
    from tests.test_pose_opt import _np_rodrigues

    from tinysplat_tpu.data.synthetic import random_gaussian_cloud
    from tinysplat_tpu.render import render as jax_render

    means, log_scales, _, colors, opac = random_gaussian_cloud(60, seed=7)
    jstate = jax_init_from_pcd(means, colors * 255, sh_degree=1, capacity=64)
    jstate = dataclasses.replace(jstate, params=dataclasses.replace(
        jstate.params,
        scales=jnp.asarray(np.pad(log_scales, ((0, 4), (0, 0)), constant_values=-10.0)),
        opacities=jnp.asarray(np.pad(opac, ((0, 4), (0, 0)), constant_values=-20.0))))
    for cam in jscene.cameras:
        rgb, _ = jax_render(jstate.params, jstate.alive, cam.params(), SIZE, SIZE,
                            jnp.int32(1), jnp.zeros(3), rasterizer="dense")
        cam._image = np.asarray(rgb)
    scene = port_scene(jscene)
    rng = np.random.default_rng(5)
    true_views = [c.view_matrix.copy() for c in scene.cameras]
    for c in scene.cameras:
        Rd = _np_rodrigues(rng.normal(scale=0.02, size=3))
        V = c.view_matrix.copy()
        V[:3, :3] = Rd @ c.view_matrix[:3, :3]
        V[:3, 3] = Rd @ c.view_matrix[:3, 3] + rng.normal(scale=0.02, size=3)
        c.view_matrix = V.astype(np.float32)

    def err(tr=None):
        tot = 0.0
        for i, c in enumerate(scene.cameras):
            V = torch.from_numpy(c.view_matrix)
            if tr is not None:
                V = apply_pose_delta(c.params("cpu"), tr.pose_deltas[i]).viewmat
            tot += float((V - torch.from_numpy(true_views[i])).abs().sum())
        return tot

    cfg = Config(rasterizer="dense", sh_degree=1, max_iter=40, warmup_densify=10**9,
                 interval_opacity_reset=0, pose_opt=True, lr_pose=3e-3, lr_means=0.0,
                 lr_colors_dc=0.0, lr_colors_rest=0.0, lr_scales=0.0, lr_quats=0.0,
                 lr_opacities=0.0, prefetch_images=False)
    tr = Trainer(cfg, scene, tt.from_jax_params(leaves_of(jstate), "cpu"))
    means0 = tr.state.params.means.detach().clone()
    e0 = err()
    tr.run(40)
    assert err(tr) < 0.5 * e0, (e0, err(tr))
    assert torch.equal(tr.state.params.means.detach(), means0)


# -- coarse to fine, budget retune ----------------------------------------------------


def test_c2f_schedule_and_intrinsics_match_jax():
    kw = dict(rasterizer="dense", sh_degree=1, max_iter=100, coarse_to_fine=True,
              c2f_start_scale=0.25, c2f_end=80, warmup_densify=10**9,
              interval_opacity_reset=0)
    jscene = jax_toy_scene(n_cams=2, size=64)
    jtr = JaxTrainer(JaxConfig(**kw), jscene, jax_start(cap=64))
    tr = port_trainer(Config(**kw), jax_scene=jscene)
    jcam, cam = jscene.cameras[0], tr.scene.cameras[0]
    for step in (0, 10, 39, 41, 79, 81, 200):
        jtr.step = tr.step = step
        assert tr._c2f_dims(cam) == jtr._c2f_dims(jcam)
    tr.step = 41
    assert tr._c2f_dims(cam) == (32, 32)
    cp = cam.params("cpu")
    jcp = JaxTrainer._scale_cam_params(jcam.params(), jcam, 32, 32)
    cp2 = Trainer._scale_cam_params(cp, cam, 32, 32)
    for f in ("fx", "fy", "cx_off", "cy_off", "viewmat"):
        np.testing.assert_allclose(np.asarray(getattr(cp2, f)), np.asarray(getattr(jcp, f)),
                                   rtol=1e-6)


def test_c2f_trainer_runs_through_the_stages():
    cfg = Config(rasterizer="dense", sh_degree=1, max_iter=12, coarse_to_fine=True,
                 c2f_start_scale=0.25, c2f_end=8, warmup_densify=10**9,
                 interval_opacity_reset=0)
    tr = port_trainer(cfg, jax_scene=jax_toy_scene(n_cams=2, size=64))
    tr.run(12)
    assert {k[1:] for k in tr._image_cache} == {(16, 16), (32, 32), (64, 64)}
    assert tr.last_rendered.shape == (64, 64, 3)
    assert torch.isfinite(tr.state.params.means).all()


@pytest.mark.parametrize("diag,cap_cfg", [((300, 0, 0), {}), ((5000, 700, 0), {}),
                                          ((400, 0, 9), dict(max_per_tile=512)),
                                          ((200, 0, 0), dict(dup_capacity=1000))])
def test_budget_retune_matches_jax(diag, cap_cfg):
    """The same diagnostics into both trainers' retune at an epoch boundary
    give the same budgets."""
    kw = dict(rasterizer="dense", sh_degree=1, **cap_cfg)
    jscene = jax_toy_scene(n_cams=2, size=SIZE)
    jtr = JaxTrainer(JaxConfig(**kw), jscene, jax_start(cap=256))
    tr = port_trainer(Config(**kw), jax_scene=jscene, jstate=jax_start(cap=256))
    for t in (jtr, tr):
        t.step = 4
        t._last_diag = tuple(diag)
        t._maybe_retune_budgets()
    assert (tr.cfg.dup_capacity, tr.cfg.max_per_tile) == (jtr.cfg.dup_capacity,
                                                          jtr.cfg.max_per_tile)
    assert tr._no_shrink_until == jtr._no_shrink_until
    assert (tr.cfg.dup_capacity, tr.cfg.max_per_tile) != (cap_cfg.get("dup_capacity", 0),
                                                          cap_cfg.get("max_per_tile", 0))


# -- NaN guard, checkpoints, metrics, profile, eval ----------------------------------------


def _cfg(**kw):
    base = dict(rasterizer="dense", sh_degree=1, warmup_densify=10**9,
                interval_opacity_reset=0, max_iter=6)
    base.update(kw)
    return Config(**base)


def test_nan_guard_rollback_restores_copies():
    tr = port_trainer(_cfg(nan_guard_interval=2))
    for _ in range(4):
        tr.train_step()
    snap = tr._guard_snapshot
    assert snap is not None and snap["step"] == 4
    snap_means = snap["params"]["means"].clone()
    snap_mu = snap["mu"]["means"].clone()
    # The snapshot is a copy: later in-place steps do not reach it.
    cam = tr.scene.get_random_camera(tr.step)  # the next step's camera
    key = (cam.name, cam.width, cam.height)
    good = tr._device_image(cam, cam.width, cam.height)
    tr._image_cache[key] = good * float("nan")
    tr.train_step()
    assert tr._rollbacks == 1 and tr.step == 4
    assert torch.equal(tr.state.params.means.detach(), snap_means)
    assert torch.equal(tr.opt_state.moments()[0]["means"], snap_mu)
    assert tr.opt_state.count == 4
    tr._image_cache[key] = good
    tr.train_step()
    assert tr._rollbacks == 1 and tr.step == 5
    assert all(torch.isfinite(t).all() for _, t in tr.state.params.fields())


def test_checkpoint_resume_equivalence(tmp_path):
    """4 straight steps equal 2 steps, a checkpoint, a fresh trainer and 2
    more (bit for bit on the CPU)."""
    cfg = _cfg(background="random")
    a = port_trainer(cfg)
    a.run(4)
    b = port_trainer(cfg)
    b.run(2)
    path = str(tmp_path / "ck.npz")
    from tinysplat_torch.io.checkpoint import save_checkpoint

    save_checkpoint(path, b.state, b.opt_state, b.step, b.generator.get_state())
    st, opt, step, rng = load_checkpoint(path, cfg, device="cpu")
    c = Trainer(cfg, b.scene, st, opt, step, rng)
    c.run(4)
    for name, t in a.state.params.fields():
        assert torch.equal(t, getattr(c.state.params, name)), name
    assert torch.equal(a.opt_state.moments()[1]["scales"], c.opt_state.moments()[1]["scales"])


def test_async_checkpoint_writes_what_sync_writes(tmp_path):
    outs = {}
    for mode in (False, True):
        d = tmp_path / ("async" if mode else "sync")
        tr = port_trainer(_cfg(save_checkpoints=True, checkpoint_interval=2,
                               checkpoint_dir=str(d), async_checkpoint=mode,
                               background="black"))
        tr.run(4)
        assert sorted(p.name.split("-")[-1] for p in d.glob("*.npz")) == ["2.npz", "4.npz"]
        with np.load(sorted(d.glob("*-4.npz"))[0]) as z:
            outs[mode] = {k: z[k] for k in z.files}
    assert outs[False].keys() == outs[True].keys()
    for k in outs[False]:
        np.testing.assert_array_equal(outs[False][k], outs[True][k], err_msg=k)


def test_metrics_csv_sink(tmp_path):
    csv = tmp_path / "metrics.csv"
    tr = port_trainer(_cfg(metrics_file=str(csv), warmup_grad=0),
                      jax_scene=jax_toy_scene(n_cams=2, size=32))
    tr.run(4)  # 2 cameras: 2 epoch boundaries
    lines = csv.read_text().strip().splitlines()
    assert lines[0].startswith("step,") and len(lines) == 3
    row = dict(zip(lines[0].split(","), lines[1].split(",")))
    assert float(row["loss"]) > 0 and "psnr" in row


def test_profile_window_eval_and_prefetch(tmp_path):
    tr = port_trainer(_cfg(max_iter=8, profile_steps=2, profile_start=3,
                           profile_dir=str(tmp_path / "trace")))
    tr.prefetch_images(workers=2)
    import concurrent.futures as cf

    cf.wait(tr._prefetch_futures, timeout=30)
    assert len(tr._image_cache) == CAMS
    cam = tr.scene.cameras[0]
    assert torch.equal(tr._device_image(cam, cam.width, cam.height),
                       torch.from_numpy(cam.get_original_image()))
    tr.run(8)
    assert tr._prof is None and tr.profile_summary["steps"] == 2
    assert os.path.exists(tmp_path / "trace" / tr._timestamp / "trace.json")
    tr.eval_cameras = [tr.scene.cameras[0]]
    out = tr.evaluate()
    assert np.isfinite(out["eval_psnr"]) and 0.0 <= out["eval_ssim"] <= 1.0
    assert out["num_eval_cameras"] == 1


def test_unported_trainer_options_raise():
    """Every option is ported: the diffusion views build on the
    single-device trainer (tests/test_torch_port_diffusion_guidance.py) and
    the mesh trainer refuses them; the density regularizer and MCMC are
    ported (tests/test_torch_port_mcmc.py), and so is the mesh trainer:
    without a process group it builds a one-rank mesh and trains (its N-rank
    runs: tests/test_torch_port_parallel.py)."""
    assert port_trainer(_cfg(regularize_diffusion=True))._diffusion_real_cams is None
    with pytest.raises(ValueError, match="single-device trainer"):
        MeshTrainer(_cfg(regularize_diffusion=True),
                    port_scene(jax_toy_scene(n_cams=CAMS, size=SIZE)),
                    tt.from_jax_params(leaves_of(jax_start()), "cpu"))
    for kw in (dict(regularize_density=True), dict(densify_strategy="mcmc")):
        assert port_trainer(_cfg(**kw)).density_probe is None
    tr = port_trainer(_cfg())
    import asyncio

    asyncio.run(tr.run_async(1))  # ported (slice D): tests/test_torch_port_viewer.py
    assert tr.step == 1
    mesh_tr = MeshTrainer(_cfg(), port_scene(jax_toy_scene(n_cams=CAMS, size=SIZE)),
                          tt.from_jax_params(leaves_of(jax_start()), "cpu"))
    assert (mesh_tr.n_data, mesh_tr.n_tile, mesh_tr.state.capacity) == (1, 1, 64)
    mesh_tr.run(1)
    assert mesh_tr.step == 1 and bool(torch.isfinite(mesh_tr.last_metrics["loss"]))
