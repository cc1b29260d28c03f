"""Port densify / prune / opacity reset / growth / compaction vs the JAX
package (``tinysplat_tpu.models.densify``, ``models.gaussians``,
``train_loop.grow_opt_state``).

The same numpy state and Adam moments go into both packages; the JAX
split draw (``jax.random.normal(key, (2, C, 3))``) is injected into the
port. ``alive`` and the stats are exact; parameters and moments agree to
1e-6 (the split samples' rotation runs as another einsum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.models import densify as jd
from tinysplat_tpu.models import gaussians as jg
from tinysplat_tpu.train import init_opt_state as jax_init_opt
from tinysplat_tpu.train_loop import grow_opt_state as jax_grow_opt_state

from tinysplat_torch import train as pt
from tinysplat_torch.config import Config
from tinysplat_torch.models import densify as td
from tinysplat_torch.models import gaussians as tg
from tinysplat_torch.train_loop import grow_opt_state

from tests._torch_threads import one_torch_thread  # noqa: F401

FIELDS = tg.PARAM_FIELDS
CAP, N = 64, 16
ATOL = 1e-6


def make_arrays(cap=CAP, n=N, grad=None, smax=None, opac=None, seed=0, count=3):
    """A numpy state of ``cap`` slots with ``n`` live ones (max scale
    ``smax``, sigmoid opacity ``opac``, accumulator ``grad``), random
    Adam moments and ``count``."""
    rng = np.random.default_rng(seed)
    grad = np.zeros(n, np.float32) if grad is None else np.asarray(grad, np.float32)
    smax = np.full(n, 0.005, np.float32) if smax is None else np.asarray(smax, np.float32)
    opac = np.full(n, 0.9, np.float32) if opac is None else np.asarray(opac, np.float32)
    scales = np.full((cap, 3), -10.0, np.float32)
    scales[:n] = np.log(smax)[:, None] - np.log([2.0, 1.5, 1.0]).astype(np.float32)
    quats = np.zeros((cap, 4), np.float32)
    quats[:, 0] = 1.0
    quats[:n] = rng.normal(size=(n, 4))
    opacities = np.full((cap, 1), -20.0, np.float32)
    p = np.clip(opac, 1e-6, 1 - 1e-6)
    opacities[:n, 0] = np.log(p / (1 - p))
    accum = np.zeros(cap, np.float32)
    accum[:n] = grad
    a = {"means": rng.normal(size=(cap, 3)).astype(np.float32),
         "colors_dc": rng.normal(size=(cap, 3)).astype(np.float32),
         "colors_rest": rng.normal(size=(cap, 8, 3)).astype(np.float32),
         "scales": scales, "quats": quats, "opacities": opacities,
         "alive": np.arange(cap) < n, "accum": accum, "count": count}
    a["mu"] = {k: rng.normal(size=a[k].shape).astype(np.float32) for k in FIELDS}
    a["nu"] = {k: rng.uniform(size=a[k].shape).astype(np.float32) for k in FIELDS}
    return a


def jax_pair(a, cfg=None):
    state = jg.GaussianState(
        params=jg.GaussianParams(**{k: jnp.asarray(a[k]) for k in FIELDS}),
        alive=jnp.asarray(a["alive"]), means_grad_accum=jnp.asarray(a["accum"]),
        active_sh_degree=jnp.int32(2))
    opt = jax_init_opt(cfg or JaxConfig(), state)
    adam = opt[0]._replace(
        count=jnp.int32(a["count"]),
        mu=jg.GaussianParams(**{k: jnp.asarray(v) for k, v in a["mu"].items()}),
        nu=jg.GaussianParams(**{k: jnp.asarray(v) for k, v in a["nu"].items()}))
    return state, (adam, opt[1]._replace(count=jnp.int32(a["count"])))


def torch_pair(a, cfg=None):
    state = tg.GaussianState(
        params=tg.GaussianParams(**{k: torch.tensor(a[k]) for k in FIELDS}),
        alive=torch.tensor(a["alive"]), means_grad_accum=torch.tensor(a["accum"]),
        active_sh_degree=torch.tensor(2, dtype=torch.int32))
    opt = pt.optimizer_with_moments(cfg or Config(), state.params, a["mu"], a["nu"],
                                    a["count"])
    return state, opt


def assert_same(tstate, topt, jstate, jopt, exact_params=False):
    """The port's state and optimizer equal the JAX ones."""
    np.testing.assert_array_equal(tstate.alive.numpy(), np.asarray(jstate.alive))
    np.testing.assert_allclose(tstate.means_grad_accum.numpy(),
                               np.asarray(jstate.means_grad_accum), atol=ATOL)
    mu, nu, count = topt.moments()
    assert count == int(jopt[0].count)
    for k in FIELDS:
        got = getattr(tstate.params, k).detach().numpy()
        ref = np.asarray(getattr(jstate.params, k))
        if exact_params:
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(mu[k].numpy(), np.asarray(getattr(jopt[0].mu, k)),
                                   atol=ATOL, err_msg=f"mu {k}")
        np.testing.assert_allclose(nu[k].numpy(), np.asarray(getattr(jopt[0].nu, k)),
                                   atol=ATOL, err_msg=f"nu {k}")


def _mixed():
    grad = np.zeros(N, np.float32)
    grad[:8] = 1e-3
    smax = np.linspace(0.004, 0.006, N).astype(np.float32)
    smax[4:8] = [0.02, 0.03, 0.04, 0.05]
    smax[12] = 0.6
    opac = np.full(N, 0.9, np.float32)
    opac[12] = 0.05
    return dict(grad=grad, smax=smax, opac=opac)


CASES = {
    # name: (array kwargs, cfg kwargs, expected stats)
    "clone": (dict(grad=[1e-3] * 8 + [0.0] * 8), {},
              dict(cloned=8, split=0, pruned=0, dropped=0, num_live=24)),
    "split": (dict(grad=[1e-3] * 8 + [0.0] * 8, smax=[0.02] * 8 + [0.005] * 8), {},
              dict(cloned=0, split=8, pruned=8, dropped=0, num_live=24)),
    "prune": (dict(smax=[0.005] * 12 + [0.6] + [0.005] * 3,
                   opac=[0.9] * 12 + [0.05] + [0.9] * 3), {},
              dict(cloned=0, split=0, pruned=1, dropped=0, num_live=15)),
    "mixed": (_mixed(), {}, dict(cloned=4, split=4, pruned=5, dropped=0, num_live=23)),
    "over max_gaussians": (_mixed(), dict(max_gaussians=10),
                           dict(cloned=0, split=0, pruned=0, dropped=0, num_live=16)),
    "overflow": (dict(cap=N + 8, grad=[1e-2] * N, smax=[0.02] * N), {},
                 dict(cloned=0, split=16, pruned=16, dropped=8, num_live=24)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_densify_and_prune_matches_jax(case):
    kw, cfg_kw, want = CASES[case]
    a = make_arrays(**kw)
    cap = a["alive"].shape[0]
    jcfg, cfg = JaxConfig(**cfg_kw), Config(**cfg_kw)
    key = jax.random.PRNGKey(len(case))
    eps = torch.tensor(np.asarray(jax.random.normal(key, (2, cap, 3), jnp.float32)))
    js, jo = jax_pair(a, jcfg)
    js2, jo2, jstats = jd.densify_and_prune(js, jo, key, 100, 1000, jcfg)
    ts, to = torch_pair(a, cfg)
    params_before = ts.params
    ts2, to2, stats = td.densify_and_prune(ts, to, 100, 1000, cfg, eps=eps)
    assert {k: int(v) for k, v in jax.device_get(jstats).items()} == stats == want
    # Written in place: the same parameter tensors, the same optimizer.
    assert ts2.params is params_before and to2 is to
    assert all(g["params"][0] is t for g, (_, t) in zip(to.param_groups, ts2.params.fields()))
    assert_same(ts2, to2, js2, jo2)


def test_densify_keep_on_overflow_writes_nothing():
    a = make_arrays(cap=N + 8, grad=[1e-2] * N, smax=[0.02] * N)
    ts, to = torch_pair(a)
    before = {k: getattr(ts.params, k).detach().clone() for k in FIELDS}
    mu_before = {k: v.clone() for k, v in to.moments()[0].items()}
    ts2, _, stats = td.densify_and_prune(ts, to, 100, 1000, Config(),
                                         generator=torch.Generator().manual_seed(0),
                                         keep_on_overflow=True)
    assert stats["dropped"] == 8 and stats["num_live"] == N
    assert ts2 is ts
    for k in FIELDS:
        assert torch.equal(getattr(ts.params, k), before[k])
        assert torch.equal(to.moments()[0][k], mu_before[k])


def test_prune_by_mask_matches_jax():
    a = make_arrays(seed=3)
    mask = np.zeros(CAP, bool)
    mask[[1, 5, 9, 40]] = True  # 40 is already dead
    js, jo = jax_pair(a)
    js2, jo2 = jd.prune_by_mask(js, jo, jnp.asarray(mask))
    ts, to = torch_pair(a)
    ts2, to2 = td.prune_by_mask(ts, to, torch.from_numpy(mask))
    assert int(ts2.alive.sum()) == N - 3
    assert_same(ts2, to2, js2, jo2, exact_params=True)


def test_reset_opacities_matches_jax():
    a = make_arrays(opac=np.linspace(0.001, 0.9, N), seed=4)
    js, jo = jax_pair(a)
    js2, jo2 = jd.reset_opacities(js, 0.005, opt_state=jo)
    ts, to = torch_pair(a)
    ts2, to2 = td.reset_opacities(ts, 0.005, opt_state=to)
    assert_same(ts2, to2, js2, jo2, exact_params=True)
    mu = to2.moments()[0]["opacities"][:N, 0]
    assert (mu == 0).sum() > 0 and (mu != 0).sum() > 0  # only where clamped
    # Without an optimizer, only the state.
    ts3, _ = torch_pair(a)
    out = td.reset_opacities(ts3, 0.005)
    np.testing.assert_array_equal(out.params.opacities.detach().numpy(),
                                  np.asarray(js2.params.opacities))


def test_grow_capacity_and_opt_state_match_jax():
    a = make_arrays(seed=5)
    js, jo = jax_pair(a)
    js2 = jg.grow_capacity(js, 2 * CAP)
    jo2 = jax_grow_opt_state(jo, CAP, 2 * CAP)
    ts, to = torch_pair(a)
    ts2 = tg.grow_capacity(ts, 2 * CAP)
    to2 = grow_opt_state(to, ts2)
    assert ts2.capacity == 2 * CAP and to2.count == a["count"]
    assert all(g["params"][0] is t for g, (_, t) in zip(to2.param_groups, ts2.params.fields()))
    assert_same(ts2, to2, js2, jo2, exact_params=True)
    with pytest.raises(ValueError, match="capacity"):
        tg.grow_capacity(ts, CAP - 1)


def _fragmented(cap=256, n_live=40):
    """Live splats scattered over every 6th slot, the rest dead."""
    a = make_arrays(cap=cap, n=cap, seed=6)
    idx = np.arange(0, cap, cap // n_live)[:n_live]
    alive = np.zeros(cap, bool)
    alive[idx] = True
    a["alive"] = alive
    a["scales"][~alive] = -10.0
    a["opacities"][~alive] = -20.0
    return a, idx


def test_compact_state_matches_jax():
    a, idx = _fragmented()
    js, jo = jax_pair(a)
    js2, jo2, jdid = jg.compact_state(js, jo, margin=1.5)
    ts, to = torch_pair(a)
    ts2, to2, did = tg.compact_state(ts, to, margin=1.5)
    assert did and jdid and ts2.capacity == 64  # next pow2 >= 40 * 1.5
    assert bool(ts2.alive[:40].all()) and not bool(ts2.alive[40:].any())
    assert_same(ts2, to2, js2, jo2, exact_params=True)
    # Moments followed their splats.
    np.testing.assert_array_equal(to2.moments()[0]["means"][:40].numpy(), a["mu"]["means"][idx])
    # A no-op when the target would not shrink.
    _, same_opt, did2 = tg.compact_state(ts2, to2, margin=1.5)
    assert not did2 and same_opt is to2
