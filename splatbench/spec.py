"""Find a cell's files by the names in ``BENCHMARK.json``.

- configuration ``<c>``: the ``file`` its entry names (``configs/<c>.json``);
  its ``objective`` key (``plain`` without one) names
  ``objectives/<objective>.py``, loaded by path: the reference a training
  cell's check follows, its ``CHECKS`` and ``check(inputs)``, and optionally
  ``render`` for a serving cell's check;
- traffic mix ``<t>``: ``traffic/<t>.json``; its ``kind`` is one of
  ``cells.KINDS`` or, where that has none, ``drivers/<kind>.py``, loaded by
  path (``kind``);
- the limits of the cell's correctness check: ``limits/<cell>.json``, one
  limit for each name the check returns and no other;
- per-layer metric ``<m>``: ``metrics/<m>.py``, loaded by path, whose
  ``read(ctx)`` returns the value or None.

A cell reports the end-to-end metrics whose ``workloads`` name it (or that
have none), and the per-layer metrics likewise.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, List, NamedTuple

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
    objective: ModuleType  # objectives/<config's objective>.py
    driver: Callable  # the traffic kind's run(cell, seed, seconds, trace, dev, t0)


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _module(path: Path, kind: str, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r}: {path} is not there")
    spec = importlib.util.spec_from_file_location(
        f"splatbench.{kind}s." + name.replace(".", "__").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def objective(name: str, root: Path = ROOT) -> ModuleType:
    """``objectives/<name>.py`` under ``root``'s benchmark directory."""
    return _module(root / HERE.name / "objectives" / f"{name}.py", "objective", name)


def kind(name: str, root: Path = ROOT):
    """The code of traffic kind ``name``: ``run(cell, seed, seconds, trace,
    dev, t0)``, ``CHECKS`` (the names its check returns; empty or absent
    where the configuration's objective gives them) and ``control(cell,
    seed, dev)``. ``cells.KINDS``' own, else ``drivers/<name>.py`` under
    ``root``'s benchmark directory."""
    from . import cells

    if name in cells.KINDS:
        return cells.KINDS[name]
    return _module(root / HERE.name / "drivers" / f"{name}.py", "driver", name)


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read. Refused
    (ValueError) where its limits file does not hold exactly the names its
    check returns."""
    b = benchmark(root)
    cells = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    base = root / HERE.name
    configs = {c["name"]: c for c in b["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(base / "traffic" / f"{w['traffic']}.json")
    limits = _json(base / "limits" / f"{name}.json")
    obj = objective(config.get("objective", "plain"), root)
    k = kind(traffic["kind"], root)
    names = tuple(getattr(k, "CHECKS", ())) or tuple(obj.CHECKS)
    if set(limits) != set(names):
        raise ValueError(f"limits/{name}.json holds {sorted(limits)}, but the cell's check "
                         f"returns {sorted(names)}: give each of these a limit and no other")
    return Cell(name, config, traffic, limits,
                [m for m in b["end_to_end"] if _reports(m, name)],
                [m for m in b["per_layer"] if _reports(m, name)], int(w["chips"]), obj, k.run)


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module(HERE / "metrics" / f"{name}.py", "metric", name).read
