"""Objectives and drivers found by file, on the CPU at a tiny size: the
default objective checks as the inline check before it did, an objective
of a checkout's own takes a loss term the plain one cannot, a limits file
must hold exactly the check's names, a traffic kind that only a
``drivers/<kind>.py`` file knows runs through ``run.main``, and a run whose
check loads JAX prints no result."""
import json
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import tinysplat_torch.train_loop as program_loop
from splatbench import cells, inputs, run, spec
from splatbench.reference import render as R
from splatbench.reference import train as RT
from splatbench.tests.test_splatbench_run import SEED, tiny

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def main_line(capsys, cell, trace=0):
    rc = run.main(["--workload", cell.name, "--seed", str(SEED), "--seconds", "2",
                   "--trace", str(trace)], device=CPU, cell=cell)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def values(line):
    return {k: v["value"] for k, v in line["checks"].items()}


def seeing(objective, seen):
    """``objective`` with its ``check`` recording the inputs it is given."""
    def check(inp):
        seen.append(inp)
        return objective.check(inp)

    return types.SimpleNamespace(CHECKS=objective.CHECKS, reference=objective.reference,
                                 check=check)


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's files, for files of a test's own."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


# -- (a) the default objective reads what the inline check read -------------------------

def parent_compare_train(prog, ref_losses, ref_grad, ref_change):
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref_losses))
    med_g = float(np.median(list(ref_grad.values())))
    med_c = float(np.median(list(ref_change.values())))
    grad_gap = max(abs(prog["grad"][k] - ref_grad[k]) / max(ref_grad[k], med_g)
                   for k in ref_grad)
    moved = [k for k in ref_change if ref_grad[k] >= 1e-3 * med_g]
    change_gap = max(abs(prog["change"][k] - ref_change[k]) / max(ref_change[k], med_c)
                     for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def parent_train_check(cell, seed, checked, dev):
    """The train driver's check as it was written inline before objectives."""
    t = cell.traffic
    views = inputs.training_views(cell.config, t)
    gts = cells.ground_truth(cell, seed, views, dev)
    start, n = int(t["start_step"]), int(t["checked_steps"])
    th, tw = cells._tiles(cell)
    lrs = {k: float(t["trainer"][f"lr_{k}"]) for k in inputs.LEAVES}
    idx = cells.scene_cameras(len(views), seed, range(start + 1, start + 1 + n))
    g = torch.Generator(device=dev).manual_seed(inputs.seed64(seed))
    bgs = [torch.rand(3, generator=g, device=dev) for _ in range(n)]
    init = cells._trainee(cell, seed, dev)
    rec = RT.train_steps(init, [R.camera(views[i], dev) for i in idx],
                         [torch.as_tensor(gts[i], device=dev) for i in idx], bgs, lrs,
                         float(t["trainer"]["lambda_dssim"]), th, tw)
    ref_change = {k: float((rec.params[k] - init[k]).norm()) for k in inputs.LEAVES}
    ref_grad = {k: float(v.norm()) for k, v in rec.first_grad.items()}
    return parent_compare_train(checked, rec.losses, ref_grad, ref_change)


def parent_serve_check(cell, seed, frames, dev):
    """The serve driver's check as it was before objectives, on the frames
    the client was sent (``frames``: every ``render_camera`` output in turn)."""
    t = cell.traffic
    poses = inputs.novel_poses(cell.config, t)
    n, warm = len(poses), int(t["warmup_passes"])
    rng = np.random.default_rng(inputs.seed64(seed))
    sample = rng.choice(n, size=int(t["checked_frames"]), replace=False)
    target = {int(p): int(rng.integers(0, int(t["checked_pass_max"]) + 1)) for p in sample}
    kept = {p: frames[(warm + k) * n + p] for p, k in target.items()}
    black = torch.tensor(t["background"], dtype=torch.float32, device=dev)
    p = cells._trainee(cell, seed, dev)
    th, tw = cells._tiles(cell)
    gaps_max, gaps_mean = [], []
    with RT.full_float32(), torch.no_grad():
        for pose, img in sorted(kept.items()):
            ref, _ = R.render(p, R.camera(poses[pose], dev), black, th, tw)
            d = (torch.as_tensor(img, device=dev) - ref).abs()
            gaps_max.append(float(d.max()))
            gaps_mean.append(float(d.mean()))
    return {"frame_max_gap": max(gaps_max), "frame_mean_gap": max(gaps_mean)}


def test_plain_train_check_reads_as_the_inline_one(capsys):
    cell = tiny("train.splats-262k")
    assert cell.objective.CHECKS == ("loss_gap", "grad_gap", "change_gap")
    seen = []
    line = main_line(capsys, cell._replace(objective=seeing(cell.objective, seen)))
    assert line["correct"] is True and len(seen) == 1
    assert values(line) == parent_train_check(cell, SEED, seen[0].program, CPU)


def test_plain_serve_check_reads_as_the_inline_one(capsys, monkeypatch):
    frames = []
    whole = program_loop.Trainer.render_camera

    def recording(self, cam, *args, **kwargs):
        rgb, extras = whole(self, cam, *args, **kwargs)
        frames.append(rgb.detach().clone())
        return rgb, extras

    monkeypatch.setattr(program_loop.Trainer, "render_camera", recording)
    cell = tiny("serve.splats-1m")
    assert not hasattr(cell.objective, "render")
    line = main_line(capsys, cell)
    assert line["correct"] is True
    assert values(line) == parent_serve_check(cell, SEED, frames, CPU)


# -- (b) an objective of a checkout's own ------------------------------------------------

ENTROPY = '''"""The plain objective and the port's opacity entropy
(``Config.regularize_opacity``): lambda_opacity times the mean over live
splats of the binary entropy of sigmoid(opacity), inside its window."""
import torch

from splatbench.objectives import plain

CHECKS = plain.CHECKS + ("opacity_term_gap",)


def entropy(p):
    o = torch.sigmoid(p["opacities"].reshape(-1))
    ent = -(o * torch.log(o + 1e-10) + (1 - o) * torch.log(1 - o + 1e-10))
    return ent.sum() / ent.numel()


def reference(inputs):
    c, terms = inputs.config, []

    def extra(p, i):
        step = inputs.steps[i - 1]
        gate = 1.0 if c["regularize_opacity_start"] <= step < c["regularize_opacity_end"] else 0.0
        term = entropy(p)
        terms.append({"loss_opacity": float(term.detach())})
        return gate * float(c["lambda_opacity"]) * term

    return dict(plain.reference(inputs, extra=extra), terms=terms)


def check(inputs):
    ref = reference(inputs)
    gap = max(abs(p["loss_opacity"] - r["loss_opacity"]) / abs(r["loss_opacity"])
              for p, r in zip(inputs.program["terms"], ref["terms"]))
    return dict(plain.compare_train(inputs.program, ref["losses"], ref["grad"], ref["change"]),
                opacity_term_gap=gap)
'''


def entropy_cell(checkout):
    (checkout / "splatbench" / "objectives" / "entropy.py").write_text(ENTROPY)
    cell = tiny("train.splats-262k")
    traffic = dict(cell.traffic)
    traffic["trainer"] = dict(traffic["trainer"], regularize_opacity=True,
                              regularize_opacity_start=15001, regularize_opacity_end=15003,
                              lambda_opacity=0.2)
    return cell._replace(traffic=traffic)


def test_an_objective_by_file_takes_a_term_the_plain_one_cannot(capsys, checkout):
    cell = entropy_cell(checkout)
    obj = spec.objective("entropy", root=checkout)
    limits = dict(cell.limits, opacity_term_gap=1e-4)
    seen = []
    line = main_line(capsys, cell._replace(objective=seeing(obj, seen), limits=limits))
    assert line["correct"] is True, line["checks"]
    prog = seen[0].program
    assert [set(d) for d in prog["terms"]] == [{"loss_l1", "loss_ssim", "loss_opacity"}] * 3
    assert prog["live"] == [300] * 3 and prog["densify"] == [] and prog["probe"] == []
    # The plain objective fails the same cell by its loss.
    line = main_line(capsys, cell)
    assert line["correct"] is False
    assert line["checks"]["loss_gap"]["value"] > 100 * line["checks"]["loss_gap"]["limit"]


def test_the_control_goes_through_the_objective(checkout):
    cell = entropy_cell(checkout)
    obj = spec.objective("entropy", root=checkout)
    out = cells.train_control(cell._replace(objective=obj), SEED, CPU)
    assert set(out) == set(obj.CHECKS) and all(np.isfinite(v) for v in out.values())
    plain = cells.train_control(cell, SEED, CPU)
    assert set(plain) == {"loss_gap", "grad_gap", "change_gap"}


# -- (c) a limits file holds exactly the check's names -----------------------------------

@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_limits_without_a_check_are_refused(checkout, fault):
    path = checkout / "splatbench" / "limits" / "train.splats-262k.json"
    limits = json.loads(path.read_text())
    if fault == "missing":
        del limits["grad_gap"]
    else:
        limits["psnr_gap"] = 0.1
    path.write_text(json.dumps(limits))
    with pytest.raises(ValueError, match="grad_gap" if fault == "missing" else "psnr_gap"):
        spec.cell("train.splats-262k", root=checkout)
    assert spec.cell("serve.splats-1m", root=checkout).limits


# -- (d) a traffic kind that only a driver file knows ------------------------------------

STILL = '''"""One viewer client left on one training view: Trainer.render_camera over
black back to back; the check is the last frame against the reference."""
import time

import torch

from splatbench import cells, inputs
from splatbench.reference import render as R

CHECKS = ("still_max_gap",)


def run(cell, seed, seconds, trace, dev, t0):
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    views = inputs.training_views(cell.config, cell.traffic)
    trainer = Trainer(cells._program_config(cell, seed, {}),
                      Scene([cells._program_camera(v) for v in views], seed=inputs.seed64(seed)),
                      cells._program_state(cells._trainee(cell, seed, dev),
                                           int(cell.config["sh_degree"])))
    cam, black = cells._program_camera(views[0]), torch.zeros(3, device=dev)
    t_start, frames = time.perf_counter(), 0
    while frames == 0 or time.perf_counter() - t_start < seconds:
        rgb, _ = trainer.render_camera(cam, background=black)
        frames += 1
    window = time.perf_counter() - t_start
    img = rgb.detach().clone()
    del trainer

    def check():
        ref, _ = R.render(cells._trainee(cell, seed, dev), R.camera(views[0], dev), black,
                          *cells._tiles(cell))
        return {"still_max_gap": float((img - ref).abs().max())}

    return cells.Run({"frames_per_s": frames / window}, frames, 0, 0, check, None, 0,
                     window / frames, list, dict(setup_s=t_start - t0, setup_marks={}))
'''


def test_a_kind_by_file_runs_through_main(capsys, checkout):
    b = json.loads((checkout / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "still.splats-262k", "config": "splats-262k",
                           "traffic": "still", "chips": 1, "why": "one client on one view"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(b))
    bench = checkout / "splatbench"
    (bench / "drivers" / "still.py").write_text(STILL)
    (bench / "traffic" / "still.json").write_text(json.dumps(
        {"kind": "still", "views": 8, "orbit_radius": 3.0, "orbit_height": 0.15, "fov": 0.9,
         "jitter_std": 0.003}))
    (bench / "limits" / "still.splats-262k.json").write_text('{"still_max_gap": 1e-3}')
    cell = spec.cell("still.splats-262k", root=checkout)
    assert "still" not in cells.KINDS and cell.driver.__module__ == "splatbench.drivers.still"
    small = tiny("train.splats-262k").config
    line = main_line(capsys, cell._replace(config=small))
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["checks"]) == {"still_max_gap"}
    assert set(line["metrics"]) == {"setup_s", "peak_mem_gib"}


# -- JAX loaded by a file found by path -----------------------------------------------------

JAXY = '''"""The plain objective, whose check loads a module named ``jax``."""
import sys
import types

from splatbench.objectives import plain

CHECKS = plain.CHECKS
reference = plain.reference


def check(inputs):
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return plain.check(inputs)
'''


def test_jax_loaded_by_the_check_gives_no_result(capsys, checkout, monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    (checkout / "splatbench" / "objectives" / "jaxy.py").write_text(JAXY)
    cell = tiny("train.splats-262k")._replace(objective=spec.objective("jaxy", root=checkout))
    try:
        rc = run.main(["--workload", cell.name, "--seed", str(SEED), "--seconds", "2",
                       "--trace", "0"], device=CPU, cell=cell)
    finally:
        sys.modules.pop("jax", None)  # the fake; monkeypatch puts back what was there
    out, err = capsys.readouterr()
    assert rc == 3 and "['jax']" in err and "no result" in err
    # The window closed with no JAX loaded; the check loaded it.
    assert any(l.startswith("window: ") for l in out.splitlines())
    assert not any(l.startswith("{") for l in out.splitlines())
