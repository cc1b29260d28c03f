"""The SuGaR density cell: found by name with its objective, its limits the
objective's checks, its configuration ``splats-262k``'s plus the window;
its three metric readers on hand-made traces (two of them through
``metrics/launched.py``, each device event counted once by its launch);
the reference and the objective load no program or JAX module; a tiny run
whole on the CPU, and its control through the objective; on the card the
control fails the limits."""
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from splatbench import cells, run, spec
from splatbench.metrics import launched
from splatbench.tests.test_splatbench_run import SEED

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000
CPU = torch.device("cpu")
CELL = "train.sugar-262k"
NEW_METRICS = {"density_probe_ms.train", "knn_device_ms.train", "density_term_device_ms.train"}


def test_discovery_of_the_density_cell():
    c = spec.cell(CELL)
    plain = spec.cell("train.splats-262k")
    assert c.config["objective"] == "density"
    assert c.objective.__name__ == "splatbench.objectives.density"
    assert set(c.limits) == set(c.objective.CHECKS) == {
        "loss_gap", "grad_gap", "change_gap", "terms_gap", "knn_gap"}
    assert c.traffic["kind"] == "train" and c.driver is plain.driver and c.chips == 1
    # splats-262k's file but the names, the window's settings and the objective.
    own = ("name", "source", "deployment", "program", "assumed", "objective")
    assert {k: v for k, v in c.config.items() if k not in own} == \
        {k: v for k, v in plain.config.items() if k not in own}
    assert {k: c.config["program"][k] for k in plain.config["program"]} == \
        plain.config["program"]
    p = c.config["program"]
    assert p["regularize_density"] and not p["regularize_sdf"]
    assert (p["regularize_density_start"], p["regularize_density_end"]) == (9000, 15000)
    assert (p["lambda_density"], p["density_samples"], p["interval_densify"]) == \
        (0.2, 100_000, 100)
    names = {m["name"] for m in c.per_layer}
    assert NEW_METRICS <= names and not NEW_METRICS & {m["name"] for m in plain.per_layer}
    assert names - NEW_METRICS == {m["name"] for m in plain.per_layer}
    assert {m["name"] for m in c.end_to_end} == {m["name"] for m in plain.end_to_end}


def test_density_traffic_rebuilds_once_in_every_traced_window():
    c = spec.cell(CELL)
    t, every = c.traffic, c.config["program"]["interval_densify"]
    assert t["trace_steps"] == every
    # The first checked step rebuilds the probe, on the cadence too; no
    # densify inside the window, which the checked steps sit well inside.
    assert (t["start_step"] + 1) % every == 1 and t["trainer"]["densify_end"] == t["start_step"]
    p = c.config["program"]
    assert p["regularize_density_start"] < t["start_step"] + 1
    assert t["start_step"] + t["checked_steps"] < p["regularize_density_end"]
    late = spec.cell("train.splats-262k").traffic
    same = {k for k in late if k not in ("about", "start_step", "trainer", "trace_steps")}
    assert {k: t[k] for k in same} == {k: late[k] for k in same}


def ctx(host, calls=100):
    return types.SimpleNamespace(trace=types.SimpleNamespace(host=host), calls=calls)


def test_probe_reader_is_the_mean_rebuild_and_none_without_one():
    read = spec.metric_reader("density_probe_ms.train")
    spans = [(0, 900 * MS, "ts.trainer.step"), (10 * MS, 510 * MS, "ts.trainer.density_probe"),
             (20 * MS, 30 * MS, "ts.density.sample"), (40 * MS, 500 * MS, "ts.density.knn")]
    assert read(ctx(spans)) == pytest.approx(500.0)
    assert read(ctx([s for s in spans if s[2] != "ts.trainer.density_probe"])) is None
    assert read(types.SimpleNamespace(trace=None, calls=0)) is None


def fake_records():
    """Two rebuilds' KNN spans and a term span; device events launched in
    them, one launched between the spans, one whose launch was not traced."""
    spans = [("ts.trainer.density_probe", 0, 100 * MS), ("ts.density.knn", 10 * MS, 60 * MS),
             ("ts.train_step.density", 200 * MS, 210 * MS),
             ("ts.density.knn", 300 * MS, 340 * MS)]
    launches = {1: 11 * MS, 2: 59 * MS, 3: 80 * MS, 4: 205 * MS, 5: 300 * MS}
    device = [(1, 100 * MS), (2, 300 * MS), (3, 7 * MS), (4, 2 * MS), (5, 500 * MS),
              (6, 9 * MS), (2, 1 * MS)]
    return launched.Records(spans, launches, device)


def test_launched_work_counts_each_device_event_once_by_its_launch():
    rec = fake_records()
    assert launched.device_ns(rec, ("ts.density.knn",)) == (901 * MS, 2)
    assert launched.device_ns(rec, ("ts.train_step.density",)) == (2 * MS, 1)
    assert launched.device_ns(rec, ("ts.no.such",)) == (0, 0)
    assert launched.records(None) is None


def test_knn_and_term_readers(monkeypatch):
    monkeypatch.setattr(launched, "records", lambda trace: fake_records())
    knn = spec.metric_reader("knn_device_ms.train")
    term = spec.metric_reader("density_term_device_ms.train")
    assert knn(ctx([])) == pytest.approx(450.5)
    assert term(ctx([], calls=4)) == pytest.approx(0.5)
    assert term(ctx([], calls=0)) is None
    monkeypatch.setattr(launched, "records",
                        lambda trace: launched.Records([], {}, [(1, 5 * MS)]))
    assert knn(ctx([])) is None and term(ctx([])) is None


def test_launch_records_of_a_cpu_profile():
    """On the CPU a profile holds the spans and no device event: the readers
    read nothing."""
    from splatbench import trace as tr
    from tinysplat_torch.utils.profiling import span

    prof = tr.start(CPU)
    with span("ts.density.knn"):
        torch.ones(8).sum()
    tr.stop(prof, CPU)
    t = tr.Trace(prof)
    rec = launched.records(t)
    assert [n for n, _, _ in rec.spans] == ["ts.density.knn"] and rec.device == []
    context = types.SimpleNamespace(trace=t, calls=1)
    assert spec.metric_reader("knn_device_ms.train")(context) is None
    assert spec.metric_reader("density_term_device_ms.train")(context) is None


def test_the_reference_and_objective_load_no_program_or_jax_module():
    code = ("import sys; from splatbench import spec; "
            "import splatbench.reference.density; spec.objective('density'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tinysplat_torch', 'tinysplat_tpu', 'jax', 'jaxlib', 'flax', 'optax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []


def tiny():
    c = spec.cell(CELL)
    cfg = dict(c.config, n_splats=2048, capacity=2048, height=48, width=64)
    cfg["program"] = dict(cfg["program"], tile_x=16, dup_capacity=60_000, max_per_tile=4096,
                          span_capacity=60_000, density_samples=512)
    return c._replace(config=cfg, traffic=dict(c.traffic, warmup_steps=1, trace_steps=2))


def test_a_tiny_run_is_correct(capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                  device=CPU, cell=tiny())
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in spec.cell(CELL).end_to_end}


def test_the_control_goes_through_its_objective():
    cell = tiny()
    out = cells.train_control(cell, SEED, CPU)
    assert set(out) == set(cell.objective.CHECKS)
    assert all(np.isfinite(v) for v in out.values())
    # In TF32 the KNN's cross product moves neighbours.
    assert out["knn_gap"] > cell.limits["knn_gap"]


@pytest.mark.cuda
def test_control_fails_the_limits_on_the_card(card):
    from splatbench.tests.test_splatbench_card import small

    cell = small(CELL)
    out = spec.kind(cell.traffic["kind"]).control(cell, 20260101, card)
    assert any(v > cell.limits[k] for k, v in out.items()), out
