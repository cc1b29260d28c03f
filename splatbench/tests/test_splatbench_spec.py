"""BENCHMARK.json against the benchmark's contract, and discovery by name."""
import json
import re
from pathlib import Path

import pytest

from splatbench import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
B = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["splatbench"] and 1 <= B["run_seconds"] <= 51
    assert all(_line(w) for w in B["command"]) and len(B["command"]) <= 32


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in B[group]]
        assert len(names) == len(set(names)), group
        for e in B[group]:
            assert set(e) - {"workloads"} == want, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_cells_configs_and_bounds():
    configs = {c["name"] for c in B["configs"]}
    assert {w["config"] for w in B["workloads"]} == configs
    for c in B["configs"]:
        assert c["file"].startswith("splatbench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == []
    for w in B["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"])
    bounds = {m["name"]: m["bound"] for m in B["end_to_end"]}
    assert bounds["setup_s"] == 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in B["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    c = spec.cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        assert callable(spec.metric_reader(m["name"]))
    assert c.traffic["kind"] in ("train", "serve") and c.limits


def test_per_layer_layers_and_roofline_names():
    for m in B["per_layer"]:
        assert m["workloads"] and m["moves"] in {e["name"] for e in B["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
    assert any("mfu" in m["name"] for m in B["per_layer"])


def test_discovery_by_name(tmp_path):
    c = spec.cell("train.splats-262k")
    assert c.config["n_splats"] == 262144 and c.traffic["kind"] == "train"
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_gap"}
    s = spec.cell("serve.splats-1m")
    assert s.config["n_splats"] == 1_000_000 and s.traffic["poses"] == 120
    t = spec.cell("train.splats-1m")
    assert t.config is not c.config and t.config["n_splats"] == 1_000_000
    assert t.traffic == c.traffic and t.driver is c.driver
    with pytest.raises(KeyError):
        spec.cell("no.such-cell")


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_each_cell_finds_its_objective_and_driver(cell):
    c = spec.cell(cell)
    obj = c.config.get("objective", "plain")
    assert (ROOT / "splatbench" / "objectives" / f"{obj}.py").is_file()
    assert c.objective.__name__ == f"splatbench.objectives.{obj}" and callable(c.driver)
    k = spec.kind(c.traffic["kind"])
    assert k.run is c.driver and callable(k.control)
    if c.traffic["kind"] == "train":
        assert set(c.limits) == set(c.objective.CHECKS)
        assert callable(c.objective.check) and callable(c.objective.reference)


def test_no_objective_or_driver_no_cell(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    conf = tmp_path / "splatbench" / "configs" / "splats-262k.json"
    conf.write_text(json.dumps(dict(json.loads(conf.read_text()), objective="no-such")))
    with pytest.raises(FileNotFoundError, match="no-such"):
        spec.cell("train.splats-262k", root=tmp_path)
    mix = tmp_path / "splatbench" / "traffic" / "serve-orbit.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), kind="no-such-kind")))
    with pytest.raises(FileNotFoundError, match="no-such-kind"):
        spec.cell("serve.splats-1m", root=tmp_path)
