"""Readings that set a cell's limits: the program's and the control's.

    python3 -m splatbench.control --workload <cell> --seeds 1,2,3 [--program] [--seconds 5]

The control is the reference put in the program's place, computed one
precision below the configuration's float32: every product a float32
program could run in TF32 (``reference.render.mm`` / ``einsum`` / ``conv``)
takes operands rounded to TF32. Its outputs are judged by the cell's own
comparison against the float32 reference: for a training cell the
objective's ``reference`` in TF32 stands as the program's record of the
checked steps and its ``check`` judges it; for a serving cell the same
sampled poses (the objective's ``render`` where it has one). Each kind
gives its ``control(cell, seed, dev)`` (``spec.kind``: ``cells.KINDS`` or
``drivers/<kind>.py``). ``--program`` also drives the program itself
through the cell (a short window) on the same seeds, in the same process. One JSON line a seed and side. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from . import cells, spec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", action="store_true")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0)
    ctl = spec.kind(cell.traffic["kind"]).control
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            t0 = time.perf_counter()
            run = cell.driver(cell, seed, args.seconds, False, dev, t0)
            print(json.dumps({"seed": seed, "side": "program", **run.check(),
                              "e2e": run.e2e}), flush=True)
            del run
        t0 = time.perf_counter()
        out = ctl(cell, seed, dev)
        print(json.dumps({"seed": seed, "side": "control", **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        cells._free(dev)


if __name__ == "__main__":
    main()
