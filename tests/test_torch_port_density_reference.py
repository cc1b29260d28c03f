"""The port's SuGaR density term against the benchmark's plain reference of
it (``splatbench/reference/density.py`` and ``objectives/density.py``,
written from the paper and tinysplat's semantics), on seeded random splats
at a small size on the CPU. Nothing here imports JAX.

- The probe's draw from a generator (uniforms through the float64 area
  CDF, then the normals) equals the objective's, index for index, and
  leaves the generator where the objective's leaves it.
- The KNN equals the exact float64 reference on a grid where every
  distance is exact in float32 too, so its ties are real: duplicates of
  one position, equal distances at the 16th place, dead splats.
- The depth channel of a render, the density, beta, the term and the
  term's gradient through the depth map, by leaf, against the reference.
- Three ``Trainer`` steps of the benchmark's density cell at 2,048 splats,
  64 x 48, 16 x 16 tiles and 512 probe points, the probe built on the
  first step, pass the objective's own check at the cell's limits; the
  probe history keeps the newest rebuild's neighbour table only.
- Each of three faults (the term left out, the depth map detached from the
  term, beta detached) fails at least one of these comparisons.

Tolerances: the draw's indices and the KNN exactly; the points to 1e-6
absolute (float32 rotations of offsets under 0.05, other orders of the
same sums); the depth channel to 1e-5 of its largest value (the plain
compositing and the reference's blocks add the same terms in other
orders); the density, beta and the term to 1e-5 relative, and the term's
gradient to 2e-4 of its largest entry by leaf (the depth path divides by
beta^2 ~ 1e-5, which scales the compositing's float32 rounding up).
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tinysplat_torch import train as pt
from tinysplat_torch.config import Config
from tinysplat_torch.data.synthetic import orbit_cameras, synthetic_pcd
from tinysplat_torch.models.gaussians import PARAM_FIELDS, GaussianParams, init_from_pcd
from tinysplat_torch.regularizers import density as pd
from tinysplat_torch.render import render
from tinysplat_torch.scene import Scene
from tinysplat_torch.train_loop import Trainer

from splatbench import cells, inputs, spec
from splatbench.reference import density as RD
from splatbench.reference import render as R

from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
objective = spec.objective("density")
SEED = 9876543210987
N, H, W, S = 2048, 48, 64, 512


def tiny_cell():
    """``train.sugar-262k`` at 2,048 splats, 64 x 48, 16 x 16 tiles and 512
    probe points; its limits are the cell's."""
    c = spec.cell("train.sugar-262k")
    cfg = dict(c.config, n_splats=N, capacity=N, height=H, width=W)
    cfg["program"] = dict(cfg["program"], tile_x=16, dup_capacity=60_000, max_per_tile=4096,
                          span_capacity=60_000, density_samples=S)
    return c._replace(config=cfg, traffic=dict(c.traffic, warmup_steps=1, trace_steps=2))


def scene(seed=5):
    """(leaves, a reference camera, the program's camera) of the tiny cell."""
    cfg = tiny_cell().config
    p = inputs.make_cloud(cfg, seed, "cpu")
    view = inputs.training_views(cfg, tiny_cell().traffic)[0]
    return p, R.camera(view, "cpu"), cells._program_camera(view).params("cpu")


def program_params(p, grad=False):
    return GaussianParams(**{k: p[k].clone().requires_grad_(grad) for k in PARAM_FIELDS})


# -- the probe: draw, KNN, density ------------------------------------------------------

def test_the_probe_draw_follows_the_objective():
    p, _, _ = scene()
    alive = torch.ones(N, dtype=torch.bool)
    alive[::7] = False
    g_prog = torch.Generator().manual_seed(11)
    g_ref = torch.Generator().manual_seed(11)
    points, idxs = pd.sample_points(program_params(p), alive, S, generator=g_prog)
    u = torch.rand((S,), generator=g_ref)
    cdf = torch.cumsum(RD.area_weights(p, alive).double(), dim=0)
    want = torch.searchsorted(cdf, u.double() * cdf[-1], right=True)
    eps = torch.randn((S, 3), generator=g_ref)
    assert torch.equal(idxs, want) and bool(alive[idxs].all())
    torch.testing.assert_close(points, RD.sample(p, want, eps), rtol=0, atol=1e-6)
    assert torch.equal(g_prog.get_state(), g_ref.get_state())


def grid_case():
    """Means and points on a 1/8 grid in [-1, 1]^3 (every distance exact in
    float32), 60 of the 300 means copies of others, every 11th dead."""
    g = torch.Generator().manual_seed(3)
    means = torch.randint(-8, 9, (300, 3), generator=g).float() / 8
    means[240:] = means[torch.randint(0, 240, (60,), generator=g)]
    points = torch.randint(-8, 9, (200, 3), generator=g).float() / 8
    points[:40] = means[:40]
    alive = torch.ones(300, dtype=torch.bool)
    alive[::11] = False
    return points, means, alive


@pytest.mark.parametrize("chunk", [16, None])
def test_knn_equals_the_exact_reference_ties_included(chunk):
    points, means, alive = grid_case()
    want = RD.knn(points, means, alive)
    stats = {}
    got = pd.knn_indices(points, means, alive, k=16, chunk=chunk, stats=stats)
    assert torch.equal(got, want)
    assert stats["tied_rows"] > 50  # the exact redo ran, and on many rows
    assert not bool((~alive[got]).any())


def test_density_and_beta_match():
    p, _, _ = scene()
    alive = torch.ones(N, dtype=torch.bool)
    probe = pd.make_density_probe(program_params(p), alive, S,
                                  generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(pd.density_at_points(probe.points, probe.knn_idx,
                                                    program_params(p)),
                               RD.density(probe.points, probe.knn_idx, p), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(probe.beta, RD.beta(p, probe.knn_idx), rtol=1e-5, atol=0)


def term_gaps():
    """Gaps of the program's density term on its render's depth, against the
    reference's on its own: the depth channel (over its largest value), the
    term (relative), and the term's gradient by leaf (over the reference's
    largest entry of that leaf)."""
    p, cam, cam_p = scene()
    alive = torch.ones(N, dtype=torch.bool)
    bg = torch.tensor([0.3, 0.6, 0.9])
    probe = pd.make_density_probe(program_params(p), alive, S,
                                  generator=torch.Generator().manual_seed(2))
    params = program_params(p, grad=True)
    _, extras = render(params, alive, cam_p, H, W, torch.tensor(3), bg, tile_size=16,
                       tile_x=16, dup_capacity=60_000, max_per_tile=4096,
                       span_capacity=60_000)
    got = pd.density_loss(probe, params, extras["depth"], cam_p, H, W)
    got_g = torch.autograd.grad(got, [getattr(params, k) for k in PARAM_FIELDS],
                                allow_unused=True)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    with torch.no_grad():
        _, depth0 = RD.render(p, cam, bg, 16, 16)
    _, depth = RD.render(leaves, cam, bg, 16, 16)
    want = RD.term(probe.points, probe.knn_idx, leaves, depth, cam)
    want_g = torch.autograd.grad(want, [leaves[k] for k in PARAM_FIELDS], allow_unused=True)
    gaps = {"depth": float((extras["depth"].detach() - depth0).abs().max()
                           / depth0.abs().max()),
            "term": abs(float(got.detach()) - float(want.detach())) / abs(float(want.detach()))}
    for k, a, b in zip(PARAM_FIELDS, got_g, want_g):
        a = torch.zeros_like(p[k]) if a is None else a
        b = torch.zeros_like(p[k]) if b is None else b
        gaps[f"d/d{k}"] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return gaps


TERM_TOL = {"depth": 1e-5, "term": 1e-5}
GRAD_TOL = 2e-4


def term_holds(gaps):
    return all(v <= TERM_TOL.get(k, GRAD_TOL) for k, v in gaps.items())


def test_depth_channel_term_and_gradients_match():
    gaps = term_gaps()
    assert set(gaps) == {"depth", "term"} | {f"d/d{k}" for k in PARAM_FIELDS}
    assert term_holds(gaps), gaps


# -- three Trainer steps through the objective's check ----------------------------------

def trainer_check():
    """The objective's check of the tiny cell's three checked steps, and the
    program's record of them."""
    cell = tiny_cell()
    seen = []
    check = cell.objective.check
    obj = type("Seeing", (), dict(CHECKS=cell.objective.CHECKS,
                                  reference=staticmethod(cell.objective.reference),
                                  check=staticmethod(lambda inp: seen.append(inp) or check(inp))))
    run = cells.train(cell._replace(objective=obj), SEED, 3.0, False, torch.device("cpu"),
                      time.perf_counter())
    return run.check(), seen[0].program, cell.limits


def test_three_trainer_steps_pass_the_objectives_check():
    got, prog, limits = trainer_check()
    assert set(got) == set(limits) == set(objective.CHECKS)
    assert all(got[k] <= limits[k] for k in limits), got
    (entry,) = prog["probe"]
    assert entry["step"] == 12001 and entry["samples"] == S and entry["live"] == N
    assert entry["knn_idx"].shape == (S, 16) and isinstance(entry["tied_rows"], int)
    assert all(objective.TERM in t for t in prog["terms"])


def test_probe_history_holds_the_newest_table_only():
    """Every rebuild records its tied rows; only the newest entry holds a
    neighbour table, the live probe's own tensor."""
    cams = orbit_cameras(2, width=16, height=16)
    for cam in cams:
        cam._image = torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(3)).numpy()
    pcd = synthetic_pcd(40, seed=2)
    state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, device="cpu")
    tr = Trainer(Config(sh_degree=1, prefetch_images=False, warmup_densify=10**9,
                        regularize_density=True, regularize_density_start=0,
                        interval_densify=2, density_samples=64),
                 Scene(cams, seed=1), state)
    for _ in range(3):  # rebuilds at steps 1 and 3
        tr.train_step()
    first, last = tr.probe_history
    assert (first["step"], last["step"]) == (1, 3) and "knn_idx" not in first
    assert last["knn_idx"] is tr.density_probe.knn_idx
    assert all(isinstance(e["tied_rows"], int) for e in (first, last))


# -- three faults, each caught -----------------------------------------------------------

def _no_term(*args, **kwargs):
    loss, aux = ORIG["compute_losses"](*args, **kwargs)
    cfg, step = args[8], args[7]
    gate = pt._schedule_gate(True, cfg.regularize_density_start, cfg.regularize_density_end,
                             step)
    loss = loss - gate * cfg.lambda_density * aux.pop("loss_density")
    return loss, aux


def _depth_detached(probe, params, depth_map, *args, **kwargs):
    return ORIG["density_loss"](probe, params, depth_map.detach(), *args, **kwargs)


def _beta_detached(params, knn_idx):
    return ORIG["probe_beta"](params, knn_idx).detach()


ORIG = dict(compute_losses=pt.compute_losses, density_loss=pd.density_loss,
            probe_beta=pd.probe_beta)
FAULTS = {
    "term_left_out": (pt, "compute_losses", _no_term),
    "depth_detached": (pd, "density_loss", _depth_detached),
    "beta_detached": (pd, "probe_beta", _beta_detached),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_fails_a_comparison(monkeypatch, fault):
    mod, name, fn = FAULTS[fault]
    monkeypatch.setattr(mod, name, fn)
    got, _, limits = trainer_check()
    held = {"terms": term_holds(term_gaps()),
            "trainer": all(got[k] <= limits[k] for k in limits)}
    assert not all(held.values()), (fault, held, got)


def test_the_objective_imports_nothing_of_the_program_or_jax():
    code = ("import sys; from splatbench import spec; spec.objective('density'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tinysplat_torch', 'tinysplat_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []
