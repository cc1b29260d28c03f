"""Find a cell's files by the names in ``BENCHMARK.json``.

- configuration ``<c>``: the ``file`` its entry names (``configs/<c>.json``);
- traffic mix ``<t>``: ``traffic/<t>.json``;
- the limits of the cell's correctness check: ``limits/<cell>.json``;
- per-layer metric ``<m>``: ``metrics/<m>.py``, loaded by path, whose
  ``read(ctx)`` returns the value or None.

A cell reports the end-to-end metrics whose ``workloads`` name it (or that
have none), and the per-layer metrics likewise.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # check name -> limit
    end_to_end: List[dict]  # BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    chips: int


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    b = benchmark(root)
    cells = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in b["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = _json(HERE / "limits" / f"{name}.json")
    return Cell(name, config, traffic, limits,
                [m for m in b["end_to_end"] if _reports(m, name)],
                [m for m in b["per_layer"] if _reports(m, name)], int(w["chips"]))


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "splatbench.metrics." + name.replace(".", "__").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

