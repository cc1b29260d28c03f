"""The 3DGS-MCMC cell and the served 262k scene: found by name, the MCMC
cell's two metric readers on hand-made traces, both cells run whole at a
tiny size on the CPU (the MCMC cell's control through its objective), and
on the card each cell's control fails its limits."""
import json
import types

import numpy as np
import pytest
import torch

from splatbench import cells, run, spec
from splatbench.tests.test_splatbench_run import SEED, tiny

MS = 1_000_000
CPU = torch.device("cpu")


def test_discovery_of_the_mcmc_cell_and_the_served_262k_scene():
    c = spec.cell("train.mcmc-1m")
    plain = spec.cell("train.splats-1m")
    assert c.config["objective"] == "mcmc" and c.objective.__name__.endswith("objectives.mcmc")
    assert set(c.limits) == set(c.objective.CHECKS) == {
        "loss_gap", "grad_gap", "change_gap", "terms_gap", "relocated_gap"}
    assert c.traffic["kind"] == "train" and c.driver is plain.driver
    assert c.config["program"]["mcmc_refine_every"] == 100
    # The same cloud and camera path as train.splats-1m but the opacity tail.
    same = {k: v for k, v in c.config.items()
            if k not in ("name", "source", "deployment", "recipe", "opacity_logit_range",
                         "program", "assumed", "objective")}
    assert same == {k: plain.config[k] for k in same}
    assert {k: c.config["program"][k] for k in plain.config["program"]} == \
        plain.config["program"]
    s = spec.cell("serve.splats-262k")
    assert s.config["n_splats"] == 262144 and s.traffic == spec.cell("serve.splats-1m").traffic
    names = {m["name"] for m in c.per_layer}
    assert {"mcmc_step_device_ms.train", "mcmc_relocate_ms.train"} <= names
    assert "mcmc_step_device_ms.train" not in {m["name"] for m in plain.per_layer}
    assert {m["name"] for m in s.per_layer} == {
        m["name"] for m in spec.cell("serve.splats-1m").per_layer}


def test_mcmc_traffic_holds_one_pass_in_every_traced_window():
    c = spec.cell("train.mcmc-1m")
    t, every = c.traffic, c.config["program"]["mcmc_refine_every"]
    assert t["trace_steps"] == every
    # The second checked step ends in a pass; the first reads its gradient before.
    assert (t["start_step"] + 2) % every == 0


def ctx(host, op_s=None, calls=4):
    t = types.SimpleNamespace(host=host, device=[("k", 0, 1)], op_s=op_s or (lambda n: None))
    return types.SimpleNamespace(trace=t, calls=calls)


def test_relocate_reader_is_the_mean_pass_and_none_without_one():
    read = spec.metric_reader("mcmc_relocate_ms.train")
    spans = [(0, 100 * MS, "ts.trainer.step"), (10 * MS, 14 * MS, "ts.trainer.mcmc_relocate"),
             (50 * MS, 56 * MS, "ts.trainer.mcmc_relocate"), (60 * MS, 61 * MS, "ts.trainer.log")]
    assert read(ctx(spans)) == pytest.approx(5.0)
    assert read(ctx([s for s in spans if s[2] != "ts.trainer.mcmc_relocate"])) is None
    assert read(types.SimpleNamespace(trace=None, calls=0)) is None


def test_step_reader_is_device_ms_a_step_under_the_two_spans():
    read = spec.metric_reader("mcmc_step_device_ms.train")
    seen = []

    def op_s(names):
        seen.append(tuple(names))
        return 0.002  # 2 ms over the traced steps

    assert read(ctx([], op_s=op_s, calls=4)) == pytest.approx(0.5)
    assert seen == [("ts.train_step.mcmc_noise", "ts.train_step.mcmc_sparsity")]
    assert read(ctx([], op_s=lambda names: None)) is None
    assert read(ctx([], op_s=lambda names: 0.002, calls=0)) is None


def line_of(capsys, name, trace=0):
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds", "2",
                   "--trace", str(trace)], device=CPU, cell=tiny(name))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["train.mcmc-1m", "serve.splats-262k"])
def test_a_tiny_run_is_correct(capsys, name):
    line = line_of(capsys, name)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    want = {m["name"] for m in spec.cell(name).end_to_end}
    assert set(line["metrics"]) == want


def test_the_mcmc_control_goes_through_its_objective():
    cell = tiny("train.mcmc-1m")
    out = cells.train_control(cell, SEED, CPU)
    assert set(out) == set(cell.objective.CHECKS)
    assert all(np.isfinite(v) for v in out.values())
    # The reference's own passes agree with themselves.
    assert out["relocated_gap"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train.mcmc-1m", "serve.splats-262k"])
def test_control_fails_the_limits_on_the_card(card, name):
    from splatbench.tests.test_splatbench_card import small

    cell = small(name)
    out = spec.kind(cell.traffic["kind"]).control(cell, 20260101, card)
    assert any(v > cell.limits[k] for k, v in out.items()), out
