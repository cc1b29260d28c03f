"""Whole runs at a tiny size on the CPU (the look for a card skipped): the
result line's keys, correctness, the faults a check must catch; and the
refusal to run without a card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tinysplat_torch.train as program_train
import tinysplat_torch.train_loop as program_loop
from splatbench import run, spec

ROOT = Path(__file__).resolve().parents[2]
SEED = 9876543210987  # wider than 32 bits, as the checks' seeds are


def tiny(name):
    c = spec.cell(name)
    cfg = dict(c.config, n_splats=300, capacity=300, height=48, width=128)
    cfg["program"] = dict(cfg["program"], dup_capacity=20_000, max_per_tile=4096,
                          span_capacity=20_000)
    traffic = dict(c.traffic)
    if traffic["kind"] == "train":
        traffic.update(warmup_steps=2, trace_steps=2)
    else:
        traffic.update(poses=12, trace_frames=2, warmup_passes=1, checked_pass_max=0)
    return c._replace(config=cfg, traffic=traffic)


def run_line(capsys, name, trace=0, seconds=2.0):
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds", str(seconds),
                   "--trace", str(trace)], device=torch.device("cpu"), cell=tiny(name))
    assert rc == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["train.splats-262k", "serve.splats-1m"])
def test_line(capsys, name, trace):
    line, err = run_line(capsys, name, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert [k for k in line if k != "breakdown"] == keys and list(line)[-1] == "checks"
    assert ("breakdown" in line) == bool(trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = spec.cell(name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for k, v in line["checks"].items():
        assert v["value"] <= v["limit"] and f"check {k}: " in err
    assert err.strip().splitlines()[-1].startswith("check ")


def test_state_left_unchanged_is_caught(capsys, monkeypatch):
    monkeypatch.setattr(program_train.GaussianAdam, "step", lambda self, closure=None: None)
    line, _ = run_line(capsys, "train.splats-262k")
    assert line["correct"] is False and line["checks"]["change_gap"]["value"] >= 0.5


def test_half_the_batch_is_caught(capsys, monkeypatch):
    whole = program_train.compute_losses

    def half(*args, **kwargs):
        loss, aux = whole(*args, **kwargs)
        rgb, gt = aux["rgb"], args[4]
        h = rgb.shape[0] // 2
        part = ((1 - 0.2) * torch.mean(torch.abs(rgb[:h] - gt[:h]))
                + 0.2 * (1 - program_train.ssim(rgb[:h], gt[:h])))
        return part, aux

    monkeypatch.setattr(program_train, "compute_losses", half)
    line, _ = run_line(capsys, "train.splats-262k")
    assert line["correct"] is False


@pytest.mark.parametrize("fault", ["one_pixel", "half_frame"])
def test_altered_frame_is_caught(capsys, monkeypatch, fault):
    whole = program_loop.render

    def altered(*args, **kwargs):
        rgb, extras = whole(*args, **kwargs)
        rgb = rgb.clone()
        if fault == "one_pixel":
            rgb[3, 5, 1] += 0.01
        else:
            rgb[rgb.shape[0] // 2:] = 0.0
        return rgb, extras

    monkeypatch.setattr(program_loop, "render", altered)
    line, _ = run_line(capsys, "serve.splats-1m")
    assert line["correct"] is False


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is for machines without one")
    p = subprocess.run([sys.executable, "-m", "splatbench.run", "--workload",
                        "train.splats-262k", "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_only_the_benchmarks_files_no_result(tmp_path):
    # A checkout holding BENCHMARK.json and splatbench/ alone: the program
    # is missing, so no result.
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "splatbench.run", "--workload",
                        "serve.splats-1m", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout
