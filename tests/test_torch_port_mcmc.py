"""The port's MCMC densifier (``models/densify_mcmc.py``), the MCMC + density
train step and the trainer against the JAX package's.

``jax.random`` and torch draw different numbers, so every draw is the JAX
package's, recomputed from the key it used and handed to the port: the
relocation uniform ``u``, the step noise ``eps`` (``fold_in(key, 1)``) and
the probe's sample indices and normals. The JAX ``Trainer`` imports
``relocate_and_grow`` and ``make_density_probe`` lazily, so wrapping the
module attributes records each key without editing the JAX package.

Tolerances: ``relocation_adjustment``'s o_new to 1e-6 relative and
scale_mult to 1e-4 relative (a 32-term alternating sum); after
``relocate_and_grow``, ``alive`` and the targets exactly (a target may
differ only where ``u * total`` lies within float32 rounding of a CDF
step, 4 ulps of the total), parameters, moments and accumulator to 1e-6;
``apply_noise`` to
1e-6; the one step as tests/test_torch_port_train.py holds it; the 8-step
trainer as tests/test_torch_port_trainer.py holds its 8 steps; a resumed
MCMC run bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tinysplat_tpu import train as jt
from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.models import densify_mcmc as jm
from tinysplat_tpu.models import gaussians as jg
from tinysplat_tpu.regularizers import density as jd
from tinysplat_tpu.train_loop import Trainer as JaxTrainer

import tinysplat_torch as tt
from tinysplat_torch import train as pt
from tinysplat_torch import train_loop
from tinysplat_torch.config import Config
from tinysplat_torch.io.checkpoint import load_checkpoint, save_checkpoint
from tinysplat_torch.models import densify_mcmc as pm
from tinysplat_torch.models.gaussians import PARAM_FIELDS
from tinysplat_torch.regularizers.density import DensityProbe
from tinysplat_torch.train_loop import Trainer

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_port_train import CFG, STEP, H, W, _cam, _gt, _jax_state, _leaves
from tests.test_torch_port_trainer import (
    CAMS,
    SIZE,
    _close_to_max,
    jax_start,
    jax_toy_scene,
    leaves_of,
    port_scene,
)


def _np(x):
    return np.array(x)  # a writable copy


def _adam_leaves(opt):
    adam = opt[0]
    return ({k: _np(getattr(adam.mu, k)) for k in PARAM_FIELDS},
            {k: _np(getattr(adam.nu, k)) for k in PARAM_FIELDS}, int(adam.count))


def test_relocation_adjustment_matches_jax():
    rng = np.random.default_rng(0)
    o = rng.uniform(0.01, 0.99, 64).astype(np.float32)
    r = rng.integers(1, pm.R_MAX + 1, 64)
    r[:8] = 1
    ref_o, ref_m = jm.relocation_adjustment(jnp.asarray(o), jnp.asarray(r))
    got_o, got_m = pm.relocation_adjustment(torch.from_numpy(o), torch.from_numpy(r))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), rtol=1e-6)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), rtol=1e-4)
    np.testing.assert_array_equal(pm._COEFFS, jm._COEFFS)


def _jax_state_of(leaves):
    """A JAX GaussianState of ``leaves`` (from ``_mcmc_start``), any capacity."""
    cap = leaves["means"].shape[0]
    return jg.GaussianState(
        params=jg.GaussianParams(**{k: jnp.asarray(leaves[k]) for k in PARAM_FIELDS}),
        alive=jnp.asarray(leaves["alive"]), means_grad_accum=jnp.zeros((cap,), jnp.float32),
        active_sh_degree=jnp.int32(int(leaves["active_sh_degree"])))


def _mcmc_start(cap=64, n_live=40, n_dead=6, seed=0):
    """JAX-state leaves: n_live splats with logits U(-1, 3), the first
    n_dead of them at -8 (below mcmc_min_opacity), and anisotropic scales
    (an isotropic splat's rotation has no gradient, so its quats drift
    apart by rounding, and the probe points sampled through them follow)."""
    leaves = leaves_of(jax_start(n=n_live, cap=cap, seed=seed))
    rng = np.random.default_rng(seed)
    op = leaves["opacities"].copy()
    op[:n_live, 0] = rng.uniform(-1.0, 3.0, n_live)
    op[:n_dead, 0] = -8.0
    scales = leaves["scales"].copy()
    scales[:n_live] += rng.normal(0.0, 0.3, (n_live, 3)).astype(np.float32)
    leaves.update(opacities=op, scales=scales)
    return leaves


def _jax_targets(leaves, alive, cfg, u):
    """relocate_and_grow's target sampling, restated in jnp (the JAX
    function does not return it): (targets, cdf, u * total)."""
    params = _jax_state_of(dict(leaves, alive=alive)).params
    o = jax.nn.sigmoid(params.opacities[:, 0])
    alive = jnp.asarray(alive)
    dead_live = alive & (o < cfg.mcmc_min_opacity)
    n_live = jnp.sum(alive.astype(jnp.int32))
    cap = alive.shape[0]
    n_target = jnp.minimum(jnp.asarray(min(cfg.mcmc_cap or cap, cfg.max_gaussians, cap)),
                           (n_live.astype(jnp.float32) * cfg.mcmc_growth_factor)
                           .astype(jnp.int32))
    free_rank = jnp.cumsum((~alive).astype(jnp.int32)) - 1
    src = dead_live | ((~alive) & (free_rank < jnp.maximum(n_target - n_live, 0)))
    cdf = jnp.cumsum(jnp.where(alive & ~src, o, 0.0))
    uu = jnp.asarray(u) * cdf[-1]
    target = jnp.clip(jnp.searchsorted(cdf, uu, side="right"), 0, cap - 1)
    return np.asarray(target), np.asarray(cdf), np.asarray(uu), np.asarray(src)


def _assert_targets_match(got, ref, cdf, uu, src):
    """Equal targets at every source, except where u * total lies within
    float32 rounding (4 ulps of the total) of the CDF step between them."""
    tol = 4 * np.spacing(np.float32(cdf[-1]))
    for i in np.nonzero(src & (got != ref))[0]:
        step = cdf[min(got[i], ref[i])]
        assert abs(float(uu[i]) - float(step)) <= tol, (i, got[i], ref[i], uu[i], step)


def test_relocate_and_grow_matches_jax_with_its_draw():
    cap = 64
    leaves = _mcmc_start(cap)
    kw = dict(sh_degree=1, densify_strategy="mcmc", mcmc_growth_factor=1.3)
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    rng = np.random.default_rng(1)
    jstate = dataclasses.replace(_jax_state_of(leaves), means_grad_accum=jnp.asarray(
        rng.uniform(0, 1, cap).astype(np.float32)))
    opt = jt.init_opt_state(jcfg, jstate)
    mu = {k: rng.normal(size=leaves[k].shape).astype(np.float32) for k in PARAM_FIELDS}
    nu = {k: rng.uniform(0, 1, leaves[k].shape).astype(np.float32) for k in PARAM_FIELDS}
    opt = (opt[0]._replace(mu=jax.tree.map(jnp.asarray, jstate.params.__class__(**mu)),
                           nu=jax.tree.map(jnp.asarray, jstate.params.__class__(**nu)),
                           count=jnp.int32(3)),) + tuple(opt[1:])
    state = tt.from_jax_params(leaves, "cpu")
    state = dataclasses.replace(state, means_grad_accum=torch.tensor(
        _np(jstate.means_grad_accum)))
    popt = pt.opt_state_from_jax(cfg, state, mu, nu, 3)

    key = jax.random.PRNGKey(5)
    u = _np(jax.random.uniform(key, (cap,)))
    ref_state, ref_opt, ref_stats = jm.relocate_and_grow(jstate, opt, key, jcfg)
    new, popt, stats = pm.relocate_and_grow(state, popt, cfg, u=torch.from_numpy(u))
    assert new.params is state.params  # in place
    for k in ("relocated", "grown", "num_live"):
        assert stats[k] == int(ref_stats[k]), k
    assert stats["relocated"] == 6 and stats["grown"] == 12
    np.testing.assert_array_equal(new.alive.numpy(), _np(ref_state.alive))

    ref_t, cdf, uu, src = _jax_targets(leaves, leaves["alive"], jcfg, u)
    o = torch.sigmoid(torch.from_numpy(leaves["opacities"][:, 0]))
    alive = torch.tensor(leaves["alive"])
    probs = torch.where(alive & ~torch.tensor(src), o, 0.0)
    got_t = pm.relocation_targets(probs, torch.from_numpy(u)).numpy()
    _assert_targets_match(got_t, ref_t, cdf, uu, src)

    for name, t in new.params.fields():
        atol = 1e-6
        np.testing.assert_allclose(t.detach().numpy(), _np(getattr(ref_state.params, name)),
                                   rtol=1e-6, atol=atol, err_msg=name)
    rmu, rnu, count = _adam_leaves(ref_opt)
    pmu, pnu, pcount = popt.moments()
    assert pcount == count == 3
    for name in PARAM_FIELDS:
        np.testing.assert_allclose(pmu[name].numpy(), rmu[name], atol=1e-6, err_msg=name)
        np.testing.assert_allclose(pnu[name].numpy(), rnu[name], atol=1e-6, err_msg=name)
    np.testing.assert_allclose(new.means_grad_accum.numpy(), _np(ref_state.means_grad_accum),
                               atol=1e-6)


def test_apply_and_inject_noise():
    cap = 32
    leaves = _mcmc_start(cap, n_live=24, n_dead=5)
    alive = leaves["alive"].copy()
    alive[20:24] = False  # dead slots never move
    cfg = Config(sh_degree=1, densify_strategy="mcmc")
    eps = _np(jax.random.normal(jax.random.PRNGKey(2), (cap, 3)))
    jp = _jax_state_of(leaves).params
    ref = jm.apply_noise(jp, jnp.asarray(alive), jnp.asarray(eps), jnp.asarray(0.1),
                         JaxConfig(sh_degree=1, densify_strategy="mcmc"))
    state = tt.from_jax_params(leaves, "cpu")
    before = state.params.means.clone()
    pm.apply_noise(state.params, torch.from_numpy(alive), torch.from_numpy(eps), 0.1, cfg)
    np.testing.assert_allclose(state.params.means.numpy(), _np(ref.means), rtol=1e-6,
                               atol=1e-6)
    moved = (state.params.means - before).abs().sum(dim=1)
    assert (moved[:5] > 0).all() and (moved[20:] == 0).all()
    gen = torch.Generator().manual_seed(0)
    pm.inject_noise(state.params, torch.from_numpy(alive), 0.1, cfg, gen)
    assert torch.isfinite(state.params.means).all()


@functools.cache
def _jax_mcmc_step():
    leaves = _leaves()
    kw = dict(rasterizer="dense", densify_strategy="mcmc", regularize_density=True,
              regularize_density_start=0, regularize_density_end=100, **CFG)
    cfg = JaxConfig(**kw)
    state = _jax_state(leaves)
    opt0 = jt.init_opt_state(cfg, state)
    key, pkey = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    probe = jd.make_density_probe(state.params, state.alive, pkey, num_samples=300)
    bg = _np(jt._resolve_background(cfg, key))
    eps = _np(jax.random.normal(jax.random.fold_in(key, 1), (leaves["means"].shape)))
    cam = jax_orbit_cameras(3, width=W, height=H)[1].params()
    mu0, nu0, _ = _adam_leaves(opt0)
    out = jt.make_train_step(cfg, H, W)(state, opt0, cam, jnp.asarray(_gt()), None,
                                        jnp.int32(STEP), key, probe)
    mu, nu, _ = _adam_leaves(out.opt_state)
    return {"leaves": leaves, "kw": kw, "bg": bg, "eps": eps, "mu0": mu0, "nu0": nu0,
            "probe": [_np(x) for x in probe], "loss": float(out.metrics["loss"]),
            "loss_density": float(out.metrics["loss_density"]),
            "params": {k: _np(getattr(out.state.params, k)) for k in PARAM_FIELDS},
            "mu": mu, "nu": nu, "accum": _np(out.state.means_grad_accum)}


def test_mcmc_density_step_matches_jax():
    ref = _jax_mcmc_step()
    cfg = Config(**ref["kw"])
    state = tt.from_jax_params(ref["leaves"], "cpu")
    opt = pt.opt_state_from_jax(cfg, state, ref["mu0"], ref["nu0"], 0)
    points, knn, beta = (torch.tensor(x) for x in ref["probe"])
    out = tt.make_train_step(cfg, H, W)(
        state, opt, _cam(), torch.from_numpy(_gt()), None, STEP,
        background=torch.from_numpy(ref["bg"]),
        density_probe=DensityProbe(points, knn.long(), beta),
        noise_eps=torch.from_numpy(ref["eps"]))
    np.testing.assert_allclose(float(out.metrics["loss"]), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(out.metrics["loss_density"]), ref["loss_density"],
                               rtol=1e-5)
    assert ref["loss_density"] > 0
    _close_to_max(out.state.means_grad_accum.numpy(), ref["accum"], 2e-4, "accum")
    lrs = pt.lr_tree(cfg)
    mu, nu, _ = opt.moments()
    for name, t in out.state.params.fields():
        _close_to_max(mu[name].numpy(), ref["mu"][name], 2e-4, f"mu {name}")
        _close_to_max(nu[name].numpy(), ref["nu"][name], 5e-4, f"nu {name}")
        g = ref["mu"][name]
        diff = np.abs(t.detach().numpy() - ref["params"][name])
        clear = np.abs(g) >= 1e-3 * np.abs(g).max()
        assert diff[clear].max() <= 1e-6 + 1e-3 * lrs[name], name
        assert diff.max() <= 1e-6 + 2 * lrs[name], name


# -- the trainer, with the JAX draws handed over ------------------------------------

MCMC_PARITY = dict(rasterizer="dense", sh_degree=1, background="black", warmup_grad=0,
                   densify_strategy="mcmc", warmup_densify=4, densify_end=6,
                   mcmc_growth_factor=1.05, regularize_density=True,
                   regularize_density_start=5, regularize_density_end=100,
                   density_samples=300, interval_opacity_reset=6, nan_guard_interval=4,
                   max_iter=8, prefetch_images=False)


@functools.cache
def _jax_trainer_run():
    """8 JAX Trainer steps: the relocation pass at step 4, the density-start
    prune and probe refresh at step 5; every draw recorded."""
    draws = {"step": [], "relocate": [], "probe": []}
    orig_relocate, orig_sample = jm.relocate_and_grow, jd.sample_points

    def relocate(state, opt_state, key, cfg):
        draws["relocate"].append(_np(jax.random.uniform(key, (state.params.capacity,))))
        return orig_relocate(state, opt_state, key, cfg)

    def sample(params, alive, key, num_samples):
        out = orig_sample(params, alive, key, num_samples)
        eps = jax.random.normal(jax.random.split(key)[1], (num_samples, 3),
                                dtype=params.means.dtype)
        draws["probe"].append((_np(out[1]), _np(eps)))
        return out

    jtr = JaxTrainer(JaxConfig(**MCMC_PARITY), jax_toy_scene(n_cams=CAMS, size=SIZE),
                     _jax_state_of(_mcmc_start()))
    step_fn = jtr._step_fn(SIZE, SIZE)

    def recorded(state, opt_state, camera, gt, est_depth, step, key, *rest):
        draws["step"].append(_np(jax.random.normal(jax.random.fold_in(key, 1),
                                                   state.params.means.shape)))
        return step_fn(state, opt_state, camera, gt, est_depth, step, key, *rest)

    jtr._step_fns[(SIZE, SIZE)] = recorded
    saved = (jm.relocate_and_grow, jd.sample_points)
    jm.relocate_and_grow, jd.sample_points = relocate, sample
    try:
        jtr.run(8)
    finally:
        jm.relocate_and_grow, jd.sample_points = saved
    mu, nu, count = _adam_leaves(jtr.opt_state)
    return draws, {
        "alive": _np(jtr.state.alive), "count": count, "mu": mu, "nu": nu,
        "params": {k: _np(getattr(jtr.state.params, k)) for k in PARAM_FIELDS},
        "accum": _np(jtr.state.means_grad_accum), "capacity": jtr.state.capacity}


def _handing_over(monkeypatch, draws):
    """Make the port's trainer take the recorded JAX draws, in order."""
    steps, relocs, probes = (list(draws[k]) for k in ("step", "relocate", "probe"))
    orig_step, orig_relocate = train_loop.make_train_step, train_loop.relocate_and_grow
    orig_probe = train_loop.make_density_probe

    def make_step(cfg, h, w):
        fn = orig_step(cfg, h, w)
        return lambda *a, **kw: fn(*a, noise_eps=torch.from_numpy(steps.pop(0)), **kw)

    def relocate(state, opt_state, cfg, generator=None):
        return orig_relocate(state, opt_state, cfg, u=torch.from_numpy(relocs.pop(0)))

    def probe(params, alive, num_samples, generator=None, timings=None):
        idxs, eps = probes.pop(0)
        return orig_probe(params, alive, num_samples, idxs=torch.from_numpy(idxs),
                          eps=torch.from_numpy(eps), timings=timings)

    monkeypatch.setattr(train_loop, "make_train_step", make_step)
    monkeypatch.setattr(train_loop, "relocate_and_grow", relocate)
    monkeypatch.setattr(train_loop, "make_density_probe", probe)
    return steps, relocs, probes


def test_mcmc_density_trainer_matches_jax_slot_by_slot(monkeypatch):
    draws, ref = _jax_trainer_run()
    assert len(draws["step"]) == 8 and len(draws["relocate"]) == 1
    assert len(draws["probe"]) == 1
    left = _handing_over(monkeypatch, draws)
    jscene = jax_toy_scene(n_cams=CAMS, size=SIZE)
    tr = Trainer(Config(**MCMC_PARITY), port_scene(jscene),
                 tt.from_jax_params(_mcmc_start(), "cpu"))
    tr.run(8)
    assert not any(left)  # every recorded draw was used
    (h,) = tr.densify_history
    assert h["step"] == 4 and h["relocated"] == 6 and h["grown"] == 2
    assert h["capacity_after"] == tr.state.capacity == ref["capacity"] == 64
    (p,) = tr.probe_history
    assert p["step"] == 5 and p["samples"] == 300 and p["live"] < 42  # pruned at 5
    assert "loss_density" in tr.last_metrics
    np.testing.assert_array_equal(tr.state.alive.numpy(), ref["alive"])
    mu, nu, count = tr.opt_state.moments()
    assert count == ref["count"] == 8
    lrs = pt.lr_tree(tr.cfg)
    for name, t in tr.state.params.fields():
        got, want, g_ref = t.detach().numpy(), ref["params"][name], ref["mu"][name]
        k = 5.0 if name == "quats" else 1.0
        diff = np.abs(got - want)
        clear = np.abs(g_ref) >= 1e-3 * np.abs(g_ref).max()
        assert diff[clear].max() <= k * 2e-4 * np.abs(want).max() + 1e-6, name
        assert diff.max() <= 1e-6 + 16 * lrs[name], name
        _close_to_max(mu[name].numpy(), ref["mu"][name], k * 2e-4, f"mu {name}")
        _close_to_max(nu[name].numpy(), ref["nu"][name], k * 5e-4, f"nu {name}")
    _close_to_max(tr.state.means_grad_accum.numpy(), ref["accum"], 2e-4, "accum")


def test_mcmc_resume_equals_the_uninterrupted_run(tmp_path):
    """6 straight MCMC steps (the refine pass at step 4, a random
    background) equal 3 steps, a checkpoint, a fresh trainer and 3 more, bit
    for bit on the CPU: the generator state rides the checkpoint."""
    cfg = Config(rasterizer="dense", sh_degree=1, densify_strategy="mcmc", warmup_densify=4,
                 densify_end=100, mcmc_growth_factor=1.2, max_iter=6, prefetch_images=False)
    scene = port_scene(jax_toy_scene(n_cams=CAMS, size=SIZE))
    a = Trainer(cfg, scene, tt.from_jax_params(_mcmc_start(), "cpu"))
    a.run(6)
    b = Trainer(cfg, scene, tt.from_jax_params(_mcmc_start(), "cpu"))
    b.run(3)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, b.state, b.opt_state, b.step, b.generator.get_state())
    st, opt, step, rng = load_checkpoint(path, cfg, device="cpu")
    c = Trainer(cfg, scene, st, opt, step, rng)
    c.run(6)
    assert [h["relocated"] for h in a.densify_history] == [
        h["relocated"] for h in c.densify_history] and a.densify_history[0]["grown"] > 0
    assert torch.equal(a.state.alive, c.state.alive)
    for name, t in a.state.params.fields():
        assert torch.equal(t, getattr(c.state.params, name)), name
    for x, y in zip(a.opt_state.moments()[:2], c.opt_state.moments()[:2]):
        for name in PARAM_FIELDS:
            assert torch.equal(x[name], y[name]), name
