"""The port's 3DGS-MCMC against the benchmark's plain reference of it
(``splatbench/objectives/mcmc.py``, written from the paper and gsplat's
``MCMCStrategy``), on seeded random splats at a small size on the CPU, and
the refine cadence ``Config.mcmc_refine_every``. Nothing here imports JAX.

- ``apply_noise`` on given normals, ``relocate_and_grow`` on given uniforms
  (targets hit by several sources, a target split below the floor and
  clamped, growth slots; parameters, live mask and the zeroed Adam moments
  slot by slot), the targets against the exact CDF over 1M opacities, eq.
  9's factor, and both sparsity terms with their gradients.
- Three ``Trainer`` steps of the benchmark's MCMC cell at a tiny size, with
  a refine pass after the second, pass the objective's own check.
- Each of five faults (relocation skipped, o_new without the root, noise
  left out, sparsity terms left out, moments not zeroed) fails at least one
  of these comparisons.

Tolerances: the noise, the sparsity terms and their gradients to 1e-5 of
their largest entry (float32, other orders of the same sums); parameters
after a pass to 1e-5 relative (eq. 9's double sum: the port's float32 table
against the reference's float64 sum); the live mask, the counts and which
moments are zero exactly.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tinysplat_torch import train as pt
from tinysplat_torch import train_loop
from tinysplat_torch.config import Config
from tinysplat_torch.data.synthetic import orbit_cameras, synthetic_pcd
from tinysplat_torch.models import densify_mcmc as pm
from tinysplat_torch.models.gaussians import PARAM_FIELDS, GaussianParams, GaussianState
from tinysplat_torch.models.gaussians import init_from_pcd
from tinysplat_torch.scene import Scene

from splatbench import cells, spec

from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
mcmc = spec.objective("mcmc")
SEED = 9876543210987
FLOOR = 0.005
MCMC = dict(densify_strategy="mcmc", sh_degree=1, mcmc_min_opacity=FLOOR,
            mcmc_growth_factor=1.05, lambda_mcmc_opacity=0.01, lambda_mcmc_scale=0.01)
REF_CFG = dict(mcmc_min_opacity=FLOOR, mcmc_cap=0, mcmc_growth_factor=1.05)


def splats(n, seed, logits=(-7.0, 3.0), scales=(0.02, 0.2)):
    """Seeded random splats (SH degree 1) as the reference's leaf dict."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = scales
    olo, ohi = logits
    q = torch.randn(n, 4, generator=g)
    return dict(means=torch.randn(n, 3, generator=g) * 0.4,
                colors_dc=torch.rand(n, 3, generator=g) - 0.5,
                colors_rest=torch.randn(n, 3, 3, generator=g) * 0.05,
                scales=torch.log(torch.rand(n, 3, generator=g) * (hi - lo) + lo),
                quats=q / q.norm(dim=-1, keepdim=True),
                opacities=torch.rand(n, 1, generator=g) * (ohi - olo) + olo)


def program_state(p, alive):
    return GaussianState(params=GaussianParams(**{k: p[k].clone() for k in PARAM_FIELDS}),
                         alive=alive.clone(), means_grad_accum=torch.zeros(alive.shape[0]),
                         active_sh_degree=torch.tensor(1, dtype=torch.int32))


def aim(p, alive, sources, u, picks):
    """Set ``u`` of each source in ``picks`` (source -> target) to the middle
    of its target's step of the cumulative opacity the pass samples from."""
    o = torch.sigmoid(p["opacities"][:, 0])
    src = torch.zeros_like(alive)
    src[sources] = True
    probs = torch.where(alive & ~src, o, 0.0)
    cdf = torch.cumsum(probs, 0)
    for s, t in picks.items():
        u[s] = (cdf[t] - 0.5 * probs[t]) / cdf[-1]


# -- the noise, the pass and the terms, function by function ------------------------------

def noise_gap(eps_scale=8.0):
    """(largest gap, largest reference entry) of ``apply_noise`` against the
    reference's noise on given normals, some slots dead."""
    n = 300
    p = splats(n, seed=1, logits=(-7.0, -2.0))
    alive = torch.arange(n) < 260
    eps = torch.randn(n, 3, generator=torch.Generator().manual_seed(2))
    params = GaussianParams(**{k: p[k].clone() for k in PARAM_FIELDS})
    pm.apply_noise(params, alive, eps, eps_scale, Config(**MCMC))
    got = params.means - p["means"]
    want = mcmc.noise(p, alive, eps, eps_scale)
    return float((got - want).abs().max()), float(want.abs().max()), got, alive


def pass_start():
    """200 live of 300 slots, growing to 209 (200 x 1.05 in float32; gsplat's
    double gives 210), 20 live splats under the floor, random Adam moments;
    the uniforms aim three sources (a growth slot among them) at slot 7, one
    at slot 11 (opacity 0.008: split in two it falls under the floor) and
    one at slot 12."""
    n, live = 300, 200
    p = splats(n, seed=3, logits=(-4.0, 3.0))
    alive = torch.arange(n) < live
    low = torch.arange(40, 60)
    p["opacities"][low] = -6.0
    p["opacities"][11] = float(torch.logit(torch.tensor(0.008)))
    g = torch.Generator().manual_seed(4)
    mu = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
    nu = {k: torch.rand(v.shape, generator=g) for k, v in p.items()}
    u = torch.rand(n, generator=g)
    sources = torch.cat([low, torch.arange(live, live + 9)])
    aim(p, alive, sources, u, {40: 7, 41: 7, 200: 7, 42: 11, 43: 12})
    return p, alive, mu, nu, u


def pass_gaps():
    """The port's pass against the reference's on ``pass_start``: a dict of
    what differs (empty when they agree), and the reference's counts."""
    p, alive, mu, nu, u = pass_start()
    cfg = Config(**MCMC)
    state = program_state(p, alive)
    opt = pt.optimizer_with_moments(cfg, state.params, mu, nu, 3)
    new, opt, stats = pm.relocate_and_grow(state, opt, cfg, u=u.clone())
    ref = {k: v.clone() for k, v in p.items()}
    rmu, rnu = ({k: v.clone() for k, v in d.items()} for d in (mu, nu))
    ref_alive, ref_stats = mcmc.relocate(ref, alive.clone(), [rmu, rnu], u, REF_CFG)
    gaps = {}
    if not torch.equal(new.alive, ref_alive):
        gaps["alive"] = int((new.alive != ref_alive).sum())
    for k in mcmc.COUNTS:
        if stats[k] != ref_stats[k]:
            gaps[k] = (stats[k], ref_stats[k])
    for k in PARAM_FIELDS:
        got, want = getattr(new.params, k).detach(), ref[k]
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            gaps[k] = float((got - want).abs().max())
    pmu, pnu, _ = opt.moments()
    for k in PARAM_FIELDS:
        for name, got, want in (("mu", pmu[k], rmu[k]), ("nu", pnu[k], rnu[k])):
            if not torch.equal(got == 0, want == 0) or not torch.allclose(got, want):
                gaps[f"{name}.{k}"] = int(((got == 0) != (want == 0)).sum())
    return gaps, ref_stats, ref


def term_gaps():
    """Relative gaps of the port's two sparsity terms and of their gradients
    against the reference's, 40 of 300 slots dead (missing terms read 1)."""
    n = 300
    p = splats(n, seed=5)
    alive = torch.arange(n) < 260
    cam = orbit_cameras(1, width=32, height=32)[0]
    cfg = Config(**MCMC)
    state = program_state(p, alive)
    state.params.requires_grad_()
    _, aux = pt.compute_losses(state.params, None, state, cam.params("cpu"),
                               torch.rand(32, 32, 3), None, torch.zeros(3), 15000, cfg, 32, 32)
    leaves = {k: p[k].clone().requires_grad_() for k in ("opacities", "scales")}
    want = mcmc.sparsity(leaves, alive)
    gaps = {}
    for name, w in zip(mcmc.TERMS, want):
        if name not in aux:
            gaps[name] = 1.0
            continue
        gaps[name] = abs(float(aux[name].detach()) - float(w.detach())) / abs(float(w.detach()))
        got_g = torch.autograd.grad(aux[name], [state.params.opacities, state.params.scales],
                                    allow_unused=True)
        want_g = torch.autograd.grad(w, [leaves["opacities"], leaves["scales"]],
                                     allow_unused=True)
        for leaf, a, b in zip(("opacities", "scales"), got_g, want_g):
            a = torch.zeros_like(p[leaf]) if a is None else a
            b = torch.zeros_like(p[leaf]) if b is None else b
            scale = max(float(b.abs().max()), float(a.abs().max()), 1e-30)
            gaps[f"d{name}/d{leaf}"] = float((a - b).abs().max()) / scale
    return gaps


def test_noise_matches_the_reference_on_given_eps():
    gap, scale, got, alive = noise_gap()
    assert gap <= 1e-5 * scale, (gap, scale)
    # The gate moves the near-dead splats, the live ones only.
    moved = got.abs().amax(dim=1) > 1e-3 * scale
    assert int(moved.sum()) > 50 and not bool(moved[~alive].any())


def test_relocate_and_grow_matches_the_reference_slot_by_slot():
    gaps, stats, ref = pass_gaps()
    assert gaps == {}
    assert stats == {"relocated": 20, "grown": 9, "num_live": 209}
    # The aimed targets: slot 7 became 4 copies, slot 11 was clamped to the floor.
    np.testing.assert_allclose(float(torch.sigmoid(ref["opacities"][11, 0])), FLOOR,
                               rtol=1e-6)
    for s in (40, 41, 200):
        assert torch.equal(ref["means"][s], ref["means"][7])


def test_sparsity_terms_and_their_gradients_match():
    gaps = term_gaps()
    assert set(gaps) == {"loss_mcmc_opacity", "loss_mcmc_scale",
                         "dloss_mcmc_opacity/dopacities", "dloss_mcmc_opacity/dscales",
                         "dloss_mcmc_scale/dopacities", "dloss_mcmc_scale/dscales"}
    assert max(gaps.values()) <= 1e-5, gaps


def test_relocation_targets_follow_the_exact_cdf():
    """Over 1M opacities a float32 running sum drifts by ~0.1 of its ~3e5
    total, which moves about one draw in a hundred to a neighbouring slot;
    the port's float64 sum hits the exact CDF's slot at every draw."""
    g = torch.Generator().manual_seed(6)
    probs = torch.sigmoid(torch.rand(1_000_000, generator=g) * 9 - 6)
    u = torch.rand(20_000, generator=g)
    cdf = np.cumsum(probs.numpy().astype(np.float64))
    exact = np.searchsorted(cdf, u.numpy().astype(np.float64) * cdf[-1], side="right")
    np.testing.assert_array_equal(pm.relocation_targets(probs, u).numpy(), exact)
    f32 = torch.cumsum(probs, 0)
    drifted = torch.searchsorted(f32, u * f32[-1], right=True).numpy()
    assert (drifted != exact).sum() > 20  # what the float32 sum would have moved


def test_eq9_factor_against_the_port_table_and_a_closed_form():
    o = torch.linspace(0.01, 0.99, 33)
    for r in range(1, pm.R_MAX + 1):
        ratio = torch.full((33,), r)
        o_new, mult = pm.relocation_adjustment(o, ratio)
        want = mcmc.scale_factor(o, 1.0 - (1.0 - o) ** (1.0 / r), ratio)
        np.testing.assert_allclose(mult.numpy(), want.numpy(), rtol=1e-4, err_msg=str(r))
    # r = 2: the double sum is 2 o_new - o_new^2 / sqrt(2).
    on = 1.0 - (1.0 - o.double()) ** 0.5
    np.testing.assert_allclose(mcmc.scale_factor(o, on.float(), torch.full((33,), 2)).numpy(),
                               (o.double() / (2 * on - on ** 2 / 2 ** 0.5)).numpy(), rtol=1e-6)


# -- three Trainer steps through the objective's check ----------------------------------

def tiny_cell():
    c = spec.cell("train.mcmc-1m")
    cfg = dict(c.config, n_splats=300, capacity=300, height=48, width=128)
    cfg["program"] = dict(cfg["program"], dup_capacity=20_000, max_per_tile=4096,
                          span_capacity=20_000)
    return c._replace(config=cfg, traffic=dict(c.traffic, warmup_steps=1, trace_steps=2))


def trainer_check():
    """The objective's check of the tiny cell's three checked steps, and the
    program's record of them."""
    cell = tiny_cell()
    seen = []
    check = cell.objective.check
    obj = type("Seeing", (), dict(CHECKS=cell.objective.CHECKS,
                                  reference=staticmethod(cell.objective.reference),
                                  check=staticmethod(lambda inp: seen.append(inp) or check(inp))))
    run = cells.train(cell._replace(objective=obj), SEED, 2.0, False, torch.device("cpu"),
                      time.perf_counter())
    return run.check(), seen[0].program, cell.limits


def test_three_trainer_steps_with_a_pass_pass_the_objectives_check():
    got, prog, limits = trainer_check()
    assert set(got) == set(limits) == set(mcmc.CHECKS)
    assert all(got[k] <= limits[k] for k in limits), got
    assert [d["step"] for d in prog["densify"]] == [15000] and prog["densify"][0]["relocated"] > 0
    assert all(set(mcmc.TERMS) <= set(t) for t in prog["terms"])


# -- five faults, each caught ------------------------------------------------------------

def _skip_relocation(state, opt_state, cfg, u=None, generator=None):
    if u is None:
        u = torch.rand((state.capacity,), generator=generator, device=state.alive.device)
    return state, opt_state, {"relocated": 0, "grown": 0, "num_live": int(state.alive.sum()),
                              "cloned": 0, "split": 0, "pruned": 0, "dropped": 0}


def _no_root(opacity, ratio):
    _, mult = ORIG["relocation_adjustment"](opacity, ratio)
    return torch.clamp(opacity, 1e-7, 1.0 - 1e-7), mult


def _no_noise(params, alive, eps, lr_scaler, cfg):
    return params


def _no_terms(*args, **kwargs):
    loss, aux = ORIG["compute_losses"](*args, **kwargs)
    cfg = args[8]
    loss = (loss - cfg.lambda_mcmc_opacity * aux.pop("loss_mcmc_opacity")
            - cfg.lambda_mcmc_scale * aux.pop("loss_mcmc_scale"))
    return loss, aux


def _moments_kept(state, opt_state, cfg, u=None, generator=None):
    new, _, stats = ORIG["relocate_and_grow"](state, None, cfg, u=u, generator=generator)
    return new, opt_state, stats


ORIG = dict(relocation_adjustment=pm.relocation_adjustment, compute_losses=pt.compute_losses,
            relocate_and_grow=pm.relocate_and_grow)
FAULTS = {
    "relocation_skipped": [(pm, "relocate_and_grow", _skip_relocation),
                           (train_loop, "relocate_and_grow", _skip_relocation)],
    "o_new_without_root": [(pm, "relocation_adjustment", _no_root)],
    "noise_left_out": [(pm, "apply_noise", _no_noise)],
    "sparsity_terms_left_out": [(pt, "compute_losses", _no_terms)],
    "moments_not_zeroed": [(pm, "relocate_and_grow", _moments_kept),
                           (train_loop, "relocate_and_grow", _moments_kept)],
}


def comparisons():
    """Which comparison each holds: the noise, the pass slot by slot, the
    terms and gradients, the Trainer steps through the objective's check."""
    gap, scale, _, _ = noise_gap()
    got, _, limits = trainer_check()
    return {"noise": gap <= 1e-5 * scale, "pass": pass_gaps()[0] == {},
            "terms": max(term_gaps().values()) <= 1e-5,
            "trainer": all(got[k] <= limits[k] for k in limits)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_fails_a_comparison(monkeypatch, fault):
    for mod, name, fn in FAULTS[fault]:
        monkeypatch.setattr(mod, name, fn)
    held = comparisons()
    assert not all(held.values()), (fault, held)


# -- the refine cadence -----------------------------------------------------------------

def cadence_trainer(monkeypatch, **cfg):
    """A ``Trainer`` of 40 splats on 2 views whose densify passes only record
    their step: ``_maybe_densify`` is driven step by step."""
    cams = orbit_cameras(2, width=16, height=16)
    pcd = synthetic_pcd(40, seed=2)
    state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, device="cpu")
    steps = []

    def record(state, opt_state, *args, **kwargs):
        steps.append(tr.step)
        return state, opt_state, {"relocated": 0, "grown": 0, "num_live": 40, "cloned": 0,
                                  "split": 0, "pruned": 0, "dropped": 0}

    monkeypatch.setattr(train_loop, "relocate_and_grow", record)
    monkeypatch.setattr(train_loop, "densify_and_prune", record)
    tr = train_loop.Trainer(Config(**dict(dict(sh_degree=1, prefetch_images=False), **cfg)),
                            Scene(cams, seed=1), state)
    for s in range(1, 401):
        tr.step = s
        tr._maybe_densify()
    return steps


def test_mcmc_refine_every_runs_a_pass_each_hundred_steps_inside_the_window(monkeypatch):
    assert cadence_trainer(monkeypatch, densify_strategy="mcmc", mcmc_refine_every=100,
                           warmup_densify=50, densify_end=250) == [100, 200]
    # The window's ends count: a pass at warmup_densify and at densify_end.
    assert cadence_trainer(monkeypatch, densify_strategy="mcmc", mcmc_refine_every=100,
                           warmup_densify=100, densify_end=300) == [100, 200, 300]


def test_mcmc_refine_every_zero_keeps_the_camera_count_interval(monkeypatch):
    assert cadence_trainer(monkeypatch, densify_strategy="mcmc", mcmc_refine_every=0,
                           warmup_densify=5, densify_end=25) == list(range(6, 26, 2))


def test_the_default_strategy_ignores_mcmc_refine_every(monkeypatch):
    assert cadence_trainer(monkeypatch, mcmc_refine_every=100, warmup_densify=5,
                           densify_end=25) == list(range(6, 26, 2))


def test_a_step_reports_the_sparsity_terms_under_mcmc_only():
    """``Trainer.last_metrics`` carries both terms of the state the step
    started from (the reference's numbers) under MCMC, and neither without."""
    cams = orbit_cameras(2, width=16, height=16)
    rng = np.random.default_rng(3)
    for cam in cams:
        cam._image = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    got = {}
    for strategy in ("mcmc", "default"):
        pcd = synthetic_pcd(40, seed=2)
        state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, capacity=64, device="cpu")
        start = {k: t.detach().clone() for k, t in state.params.fields()}
        alive = state.alive.clone()
        tr = train_loop.Trainer(Config(sh_degree=1, densify_strategy=strategy,
                                       warmup_densify=10**9, prefetch_images=False),
                                Scene(cams, seed=1), state)
        tr.train_step()
        got[strategy] = tr.last_metrics
    assert not set(mcmc.TERMS) & set(got["default"])
    for name, want in zip(mcmc.TERMS, mcmc.sparsity(start, alive)):
        np.testing.assert_allclose(float(got["mcmc"][name]), float(want), rtol=1e-6)


def test_the_objective_imports_nothing_of_the_program_or_jax():
    code = ("import sys; from splatbench import spec; spec.objective('mcmc'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tinysplat_torch', 'tinysplat_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []
