"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m splatbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the inputs made from the seed, the program's kernels
loaded or built, the cell's warm-up) is ``setup_s``; then the cell's driver
(``cells.py`` or ``drivers/<kind>.py``, chosen by the traffic mix's
``kind``) measures for
``--seconds``. With ``--trace 1`` a profiler window of a few steps or frames
sits in the middle of the window and the line carries the per-layer
metrics, ``busy_s`` / ``window_s`` and a ``breakdown``; with ``--trace 0``
it carries the end-to-end metrics. Once the window has closed and the
program's state is freed, the reference checks what the timed path
produced; each number compared and its limit are printed last on standard
error and last in the line, under ``checks``.

Exits non-zero with no result line when CUDA is not available or has
fewer cards than the cell asks for, and when a JAX module (``jax``,
``jaxlib``, ``flax``, ``optax``, ``tinysplat_tpu``) is loaded once the
window has closed or once the check and the per-layer readers have run. A run that is not correct prints its line with
``correct: false`` and exits 0.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")  # keep transformers from loading JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tinysplat_tpu")
GIB = 1024 ** 3


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line(count: int) -> str:
    """The cards' name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return f"cards: {count}; " + ("; ".join(out) if out else "nvidia-smi unreadable")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, cell=None) -> int:
    """``device`` None: the card, refused unless CUDA has the cell's cards.
    Tests pass ``torch.device("cpu")`` and a small ``spec.Cell`` to drive the
    rest of a run."""
    args = parse(argv)
    import torch

    from . import spec

    imported = time.perf_counter() - T0

    cell = cell or spec.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"splatbench: {args.workload} needs {cell.chips} CUDA device(s), torch sees "
                  f"{have}; no result", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    torch.manual_seed(0)
    torch.set_num_threads(1)  # one busy host thread: the driver's
    run = cell.driver(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    setup_s = run.notes["setup_s"]
    run.notes["setup_marks"] = dict(imported=imported, **run.notes["setup_marks"])
    if device.type == "cuda":
        print(card_line(torch.cuda.device_count()), flush=True)
        print(f"device: {torch.cuda.get_device_name(device)}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)

    loaded = forbidden_loaded()
    if loaded:
        print(f"splatbench: JAX modules loaded in the benchmark's process: {loaded}; "
              "no result", file=sys.stderr)
        return 3
    print("window: " + json.dumps(run.notes, default=str), flush=True)

    checks = run.check()
    correct = set(checks) == set(cell.limits) and run.failed == 0 and all(
        math.isfinite(v) and v <= cell.limits[k] for k, v in checks.items())

    kind = device.type
    dev_info = {"platform": "gpu" if kind == "cuda" else kind,
                "kind": torch.cuda.get_device_name(device) if kind == "cuda" else "cpu",
                "count": cell.chips if kind == "cuda" else 0,
                "memory_peak_bytes": run.peak_bytes}
    metrics = {}
    line = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed}
    if args.trace:
        ctx = Context(run, cell)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        line["breakdown"] = run.trace.breakdown()
    else:
        values = dict(run.e2e, setup_s=setup_s, peak_mem_gib=run.peak_bytes / GIB)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = dev_info
    # Again once the check and the readers have run: an objective, a driver
    # or a metric loaded by path may have pulled JAX in.
    loaded = forbidden_loaded()
    if loaded:
        print(f"splatbench: JAX modules loaded in the benchmark's process: {loaded}; "
              "no result", file=sys.stderr)
        return 3
    line["checks"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in checks.items()}
    for k, v in checks.items():
        print(f"check {k}: {v!r} (limit {cell.limits.get(k)!r})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


class Context:
    """What a per-layer metric's ``read(ctx)`` sees: ``trace`` (a
    ``trace.Trace``), ``calls`` traced steps or frames, ``work`` (the
    reference's counts of each traced call), ``call_s`` (the measured
    window's seconds a call), ``window`` (the driver's numbers of the
    window, by name), ``config`` (the configuration file)."""

    def __init__(self, run, cell):
        self.trace = run.trace
        self.window = run.e2e
        self.calls = run.calls
        self.call_s = run.call_s
        self.config = cell.config
        self.work = run.work()


if __name__ == "__main__":
    sys.exit(main())
