"""Port train step and optimizer vs the JAX package (``tinysplat_tpu.train``).

A few hundred splats at 32x48, SH degree 2, weights and Adam moments
carried across with ``from_jax_params`` / ``opt_state_from_jax``, the same
numpy-drawn GT frame, the JAX package's background draw injected. The port
runs with ``rasterizer="dense"`` and ``"auto"`` (K1's and K2's plain
versions on CPU tensors) against the JAX step with the dense oracle.

Tolerances: the loss to 1e-5 relative; gradients, the densify accumulator
and Adam's first moment to 2e-4 x the field's max (the compositing sums run
in another order); the second moment to 5e-4 x max (it squares the
gradient); new parameters to 1e-6 + 1e-3 lr where |g| >= 1e-3 x the
field's max, and within 2 lr elsewhere (a first Adam step moves each
parameter by ~lr sign(g), and the sign of a near-zero gradient may differ);
the optimizer alone: moments to 1e-6, parameters to 1e-6 + 1e-5 relative
(optax forms Adam's bias correction 1 - 0.999^t in float32, which keeps
~5 digits at small t; torch forms it in double).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu import train as jt
from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.data.synthetic import random_gaussian_cloud
from tinysplat_tpu.models import gaussians as jg

import tinysplat_torch as tt
from tinysplat_torch import train as pt
from tinysplat_torch.config import Config
from tinysplat_torch.data.synthetic import orbit_cameras

from tests._torch_threads import one_torch_thread  # noqa: F401

H, W, N, CAP = 32, 48, 120, 128
FIELDS = ("means", "colors_dc", "colors_rest", "scales", "quats", "opacities")
STEP = 3
CFG = dict(sh_degree=2, sh_increment_interval=2, warmup_grad=0, lr_means_final=1e-5,
           lr_means_decay_steps=10)


def _leaves(seed=5, opacity=(-3.0, 3.0)):
    means, log_scales, quats, colors, _ = random_gaussian_cloud(
        N, seed=seed, scale_range=(0.03, 0.12))
    rng = np.random.default_rng(seed)

    def pad(a, fill):
        out = np.full((CAP,) + a.shape[1:], fill, np.float32)
        out[:N] = a
        return out

    quats_p = pad(quats, 0.0)
    quats_p[N:, 0] = 1.0
    return {
        "means": pad(means, 0.0),
        "colors_dc": pad((colors - 0.5) / 0.28209479177387814, 0.0),
        "colors_rest": pad((rng.normal(size=(N, 8, 3)) * 0.1).astype(np.float32), 0.0),
        "scales": pad(log_scales, -10.0),
        "quats": quats_p,
        "opacities": pad(rng.uniform(*opacity, (N, 1)).astype(np.float32), -20.0),
        "alive": np.arange(CAP) < N,
        "active_sh_degree": np.int32(1),
    }


def _jax_state(leaves):
    return jg.GaussianState(
        params=jg.GaussianParams(**{k: jnp.asarray(leaves[k]) for k in FIELDS}),
        alive=jnp.asarray(leaves["alive"]),
        means_grad_accum=jnp.zeros((CAP,), jnp.float32),
        active_sh_degree=jnp.int32(int(leaves["active_sh_degree"])))


def _gt(seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


def _cam():
    return orbit_cameras(3, width=W, height=H)[1].params(device="cpu")


@functools.cache
def _jax_step():
    """One JAX train step (dense oracle) from fresh Adam state, plus the
    gradients it took, as numpy."""
    leaves = _leaves()
    cfg = JaxConfig(rasterizer="dense", **CFG)
    state = _jax_state(leaves)
    opt0 = jt.init_opt_state(cfg, state)
    key = jax.random.PRNGKey(7)
    bg = np.array(jt._resolve_background(cfg, key))
    cam = jax_orbit_cameras(3, width=W, height=H)[1].params()
    gt = jnp.asarray(_gt())
    active = min(cfg.sh_degree, 1 + STEP // cfg.sh_increment_interval)
    (_, _), (grads, _) = jax.value_and_grad(jt.compute_losses, argnums=(0, 1), has_aux=True)(
        state.params, jnp.zeros((CAP, 2)), dataclasses.replace(
            state, active_sh_degree=jnp.int32(active)),
        cam, gt, None, jnp.asarray(bg), jnp.int32(STEP), cfg, H, W)
    ref = {
        "leaves": leaves, "bg": bg, "active": active,
        "mu0": {k: np.asarray(getattr(opt0[0].mu, k)) for k in FIELDS},
        "nu0": {k: np.asarray(getattr(opt0[0].nu, k)) for k in FIELDS},
        "grads": {k: np.asarray(getattr(grads, k)) for k in FIELDS},
    }
    out = jt.make_train_step(cfg, H, W)(state, opt0, cam, gt, None, jnp.int32(STEP), key)
    ref.update(
        loss=float(out.metrics["loss"]), psnr=float(out.metrics["psnr"]),
        params={k: np.asarray(getattr(out.state.params, k)) for k in FIELDS},
        mu={k: np.asarray(getattr(out.opt_state[0].mu, k)) for k in FIELDS},
        nu={k: np.asarray(getattr(out.opt_state[0].nu, k)) for k in FIELDS},
        accum=np.asarray(out.state.means_grad_accum))
    return ref


def _close_to_max(got, ref, rel, name):
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("rasterizer,grad_reduce",
                         [("dense", "scatter"), ("auto", "scatter"), ("auto", "mxu")])
def test_train_step_matches_jax(rasterizer, grad_reduce):
    ref = _jax_step()
    cfg = Config(rasterizer=rasterizer, grad_reduce=grad_reduce, **CFG)
    state = tt.from_jax_params(ref["leaves"], "cpu")
    opt = pt.opt_state_from_jax(cfg, state, ref["mu0"], ref["nu0"], 0)
    out = tt.make_train_step(cfg, H, W)(state, opt, _cam(), torch.from_numpy(_gt()), None,
                                        STEP, background=torch.from_numpy(ref["bg"]))
    assert out.opt_state is opt and out.state.params is state.params
    assert int(out.state.active_sh_degree) == ref["active"]
    assert out.rendered.shape == (H, W, 3)
    np.testing.assert_allclose(float(out.metrics["loss"]), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(out.metrics["psnr"]), ref["psnr"], rtol=1e-5)
    _close_to_max(out.state.means_grad_accum.numpy(), ref["accum"], 2e-4, "accum")
    lrs = pt.lr_tree(cfg)
    for name, t in out.state.params.fields():
        g_ref = ref["grads"][name]
        _close_to_max(t.grad.numpy(), g_ref, 2e-4, f"grad {name}")
        st = opt.state[t]
        _close_to_max(st["exp_avg"].numpy(), ref["mu"][name], 2e-4, f"mu {name}")
        _close_to_max(st["exp_avg_sq"].numpy(), ref["nu"][name], 5e-4, f"nu {name}")
        diff = np.abs(t.detach().numpy() - ref["params"][name])
        clear = np.abs(g_ref) >= 1e-3 * np.abs(g_ref).max()
        assert diff[clear].max() <= 1e-6 + 1e-3 * lrs[name], name
        assert diff.max() <= 1e-6 + 2 * lrs[name], name


def _jax_opt_run(cfg, params, grads):
    opt = jt.make_optimizer(cfg)
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update(jg.GaussianParams(**g), state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    return params, state


def test_optimizer_matches_optax_with_means_lr_decay():
    """Identical numpy gradients into both optimizers: 3 JAX steps, the
    moments carried across, then 3 more steps in each package."""
    cfg_kw = dict(lr_means=1e-2, lr_means_final=1e-4, lr_means_decay_steps=5)
    jcfg, cfg = JaxConfig(**cfg_kw), Config(**cfg_kw)
    leaves = _leaves(seed=2)
    rng = np.random.default_rng(0)
    grads = [{k: rng.normal(size=leaves[k].shape).astype(np.float32) for k in FIELDS}
             for _ in range(6)]
    params0 = jg.GaussianParams(**{k: jnp.asarray(leaves[k]) for k in FIELDS})
    mid, mid_state = _jax_opt_run(jcfg, params0, grads[:3])
    end, end_state = _jax_opt_run(jcfg, params0, grads)

    carried = dict(leaves, **{k: np.asarray(getattr(mid, k)) for k in FIELDS})
    state = tt.from_jax_params(carried, "cpu")
    adam = mid_state[0]
    opt = pt.opt_state_from_jax(cfg, state, {k: np.asarray(getattr(adam.mu, k)) for k in FIELDS},
                                {k: np.asarray(getattr(adam.nu, k)) for k in FIELDS},
                                int(adam.count))
    assert opt.count == 3
    for g in grads[3:]:
        for name, t in state.params.fields():
            t.grad = torch.from_numpy(g[name])
        opt.step()
    assert opt.count == 6
    np.testing.assert_allclose(opt.param_groups[0]["lr"], pt.means_lr_at(cfg, 5), rtol=1e-12)
    np.testing.assert_allclose(float(jt.means_lr_at(jcfg, jnp.int32(5))),
                               pt.means_lr_at(cfg, 5), rtol=1e-6)
    for name, t in state.params.fields():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(getattr(end, name)),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(opt.state[t]["exp_avg"].numpy(),
                                   np.asarray(getattr(end_state[0].mu, name)), atol=1e-6)
        np.testing.assert_allclose(opt.state[t]["exp_avg_sq"].numpy(),
                                   np.asarray(getattr(end_state[0].nu, name)), atol=1e-6)
    assert [g["lr"] for g in opt.param_groups[1:]] == [
        pt.lr_tree(cfg)[k] for k in FIELDS[1:]]


def test_compute_losses_regularizers_match_jax():
    """Depth and opacity-entropy terms inside and outside their windows,
    and the MCMC sparsity terms, through the dense oracle in both."""
    leaves = _leaves(seed=4)
    est = np.random.default_rng(2).uniform(2.0, 4.0, (H, W)).astype(np.float32)
    bg = np.asarray([0.2, 0.5, 0.1], np.float32)
    jcam = jax_orbit_cameras(3, width=W, height=H)[0].params()
    for step, kw in ((4, dict(densify_strategy="mcmc")), (9, {})):
        kw = dict(rasterizer="dense", regularize_depth=True, regularize_depth_start=2,
                  regularize_depth_end=6, regularize_opacity=True,
                  regularize_opacity_start=3, regularize_opacity_end=5, **kw)
        jstate = _jax_state(leaves)
        lj, aj = jt.compute_losses(jstate.params, None, jstate, jcam, jnp.asarray(_gt()),
                                   jnp.asarray(est), jnp.asarray(bg), jnp.int32(step),
                                   JaxConfig(**kw), H, W)
        state = tt.from_jax_params(leaves, "cpu")
        lt, at = tt.compute_losses(state.params, None, state, orbit_cameras(
            3, width=W, height=H)[0].params(device="cpu"), torch.from_numpy(_gt()),
            torch.from_numpy(est), torch.from_numpy(bg), step, Config(**kw), H, W)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        keys = {"loss_l1", "loss_ssim", "loss_depth", "loss_opacity"}
        if kw.get("densify_strategy") == "mcmc":
            keys |= {"loss_mcmc_opacity", "loss_mcmc_scale"}
        assert keys <= set(at) and keys <= set(aj)
        for k in keys:
            np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("option", [dict(regularize_diffusion=True), dict(mesh_tile=2)])
def test_unported_options_raise(option):
    """The step itself needs neither option. The diffusion views are ported
    (tests/test_torch_port_diffusion_guidance.py): the single-device
    trainer takes them and the mesh trainer refuses them. Multi-device
    training is ported (tests/test_torch_port_parallel.py): the CLI refuses
    a mesh only when its ranks are not there. The density regularizer and
    MCMC are ported: tests/test_torch_port_mcmc.py."""
    from tinysplat_torch import train_cli
    from tinysplat_torch.parallel import MeshTrainer
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    cfg = Config(**option)
    tt.make_train_step(cfg, H, W)
    if cfg.regularize_diffusion:
        scene = Scene(orbit_cameras(3, width=W, height=H))
        tr = Trainer(cfg, scene, tt.from_jax_params(_leaves(), "cpu"))
        assert tr._diffusion_guidance is None  # built at the window's first step
        with pytest.raises(ValueError, match="single-device trainer"):
            MeshTrainer(cfg, scene, tt.from_jax_params(_leaves(), "cpu"))
    else:
        with pytest.raises(ValueError, match="needs 2 ranks, there are 1"):
            train_cli.check_flags(cfg)
        train_cli.check_flags(cfg, world_size=2)


def test_unported_loss_arguments_raise():
    """Every loss argument is ported now: a density probe enters the loss
    only under cfg.regularize_density (tests/test_torch_port_mcmc.py)."""
    state = tt.from_jax_params(_leaves(), "cpu")
    args = (state.params, None, state, _cam(), torch.zeros(H, W, 3), None, torch.zeros(3), 0,
            Config(), H, W)
    unused, aux = tt.compute_losses(*args, density_probe=object())
    assert "loss_density" not in aux
    # pose_delta / app_params are ported: zero deltas are the identity.
    base, _ = tt.compute_losses(*args)
    assert torch.equal(base, unused)
    posed, _ = tt.compute_losses(*args, pose_delta=torch.zeros(6), app_params=torch.zeros(12))
    assert torch.equal(base, posed)


def test_backgrounds():
    assert torch.equal(pt._resolve_background(Config(background="white")), torch.ones(3))
    assert torch.equal(pt._resolve_background(Config(background="black")), torch.zeros(3))
    draws = [pt._resolve_background(Config(), torch.Generator().manual_seed(3))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and ((draws[0] >= 0) & (draws[0] < 1)).all()
    assert torch.equal(pt.fixed_background(Config(background="white")), torch.ones(3))
    assert torch.equal(pt.fixed_background(Config()), torch.zeros(3))


def test_step_sh_warmup_accumulator_gate_and_optimizer_check():
    cfg = Config(sh_degree=2, sh_increment_interval=3, warmup_grad=5)
    state = tt.from_jax_params(_leaves(), "cpu")
    opt = tt.init_opt_state(cfg, state)
    step_fn = tt.make_train_step(cfg, H, W)
    gt = torch.from_numpy(_gt())
    out = step_fn(state, opt, _cam(), gt, None, 4, generator=torch.Generator().manual_seed(0))
    assert int(out.state.active_sh_degree) == 2  # min(2, 1 + 4 // 3)
    assert (out.state.means_grad_accum == 0).all()  # step 4 < warmup_grad
    assert out.metrics["n_dup_dropped"] == 0 and out.metrics["n_intersections"] > 0
    assert all(torch.is_tensor(out.metrics[k]) for k in ("loss", "psnr", "num_live"))
    out = step_fn(out.state, out.opt_state, _cam(), gt, None, 5)
    assert float(out.state.means_grad_accum.sum()) > 0
    assert int(out.metrics["num_live"]) == N
    other = tt.from_jax_params(_leaves(), "cpu")
    with pytest.raises(ValueError, match="init_opt_state"):
        step_fn(other, opt, _cam(), gt, None, 6)


def test_steps_reduce_loss():
    """GT rendered from the unperturbed scene; training from dimmed
    opacities and perturbed colours lowers the loss (plain K1/K2)."""
    leaves = _leaves(seed=6)
    target = tt.from_jax_params(leaves, "cpu")
    bg = torch.zeros(3)
    with torch.no_grad():
        gt, _ = tt.render(target.params, target.alive, _cam(), H, W, 2, bg)
    noise = np.random.default_rng(0).normal(0, 0.1, leaves["colors_dc"].shape)
    start = dict(leaves, opacities=np.where(leaves["alive"][:, None], -1.0,
                                            leaves["opacities"]).astype(np.float32),
                 colors_dc=(leaves["colors_dc"] + noise).astype(np.float32))
    cfg = Config(background="black", warmup_grad=0, lr_opacities=0.1)
    state = tt.from_jax_params(start, "cpu")
    opt = tt.init_opt_state(cfg, state)
    step_fn = tt.make_train_step(cfg, H, W)
    losses = []
    for step in range(8):
        out = step_fn(state, opt, _cam(), gt, None, step)
        state = out.state
        losses.append(float(out.metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0], losses
