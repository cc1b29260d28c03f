"""Readings that set a cell's limits: the program's and the control's.

    python3 -m splatbench.control --workload <cell> --seeds 1,2,3 [--program] [--seconds 5]

The control is the reference put in the program's place, computed one
precision below the configuration's float32: every product a float32
program could run in TF32 (``reference.render.mm`` / ``einsum`` / ``conv``)
takes operands rounded to TF32. Its outputs are judged by the cell's own
comparison against the float32 reference: the same checked steps for a
training cell, the same sampled poses for a serving cell. ``--program``
also drives the program itself through the cell (a short window) on the
same seeds, in the same process. One JSON line a seed and side. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import cells, inputs, spec
from .reference import render as R
from .reference import train as RT


def control_train(cell, seed: int, dev):
    t = cell.traffic
    views = inputs.training_views(cell.config, t)
    gts = cells.ground_truth(cell, seed, views, dev)
    th, tw = cells._tiles(cell)
    start, n = int(t["start_step"]), int(t["checked_steps"])
    idx = cells.scene_cameras(len(views), seed, range(start + 1, start + 1 + n))
    g = torch.Generator(device=dev).manual_seed(inputs.seed64(seed))
    bgs = [torch.rand(3, generator=g, device=dev) for _ in range(n)]
    init = cells._trainee(cell, seed, dev)
    lrs = {k: float(t["trainer"][f"lr_{k}"]) for k in inputs.LEAVES}
    args = (init, [R.camera(views[i], dev) for i in idx],
            [torch.as_tensor(gts[i], device=dev) for i in idx], bgs, lrs,
            float(t["trainer"]["lambda_dssim"]), th, tw)
    ref = RT.train_steps(*args)
    with R.tf32():
        low = RT.train_steps(*args)
    side = dict(losses=low.losses,
                grad={k: float(v.norm()) for k, v in low.first_grad.items()},
                change={k: float((low.params[k] - init[k]).norm()) for k in inputs.LEAVES})
    return cells.compare_train(side, ref.losses,
                               {k: float(v.norm()) for k, v in ref.first_grad.items()},
                               {k: float((ref.params[k] - init[k]).norm()) for k in inputs.LEAVES})


@torch.no_grad()
def control_serve(cell, seed: int, dev):
    t = cell.traffic
    poses = inputs.novel_poses(cell.config, t)
    rng = np.random.default_rng(inputs.seed64(seed))
    sample = rng.choice(len(poses), size=int(t["checked_frames"]), replace=False)
    p = cells._trainee(cell, seed, dev)
    th, tw = cells._tiles(cell)
    bg = torch.tensor(t["background"], dtype=torch.float32, device=dev)
    gmax, gmean = [], []
    with RT.full_float32():
        for pose in sorted(int(x) for x in sample):
            cam = R.camera(poses[pose], dev)
            ref, _ = R.render(p, cam, bg, th, tw)
            with R.tf32():
                low, _ = R.render(p, cam, bg, th, tw)
            d = (low - ref).abs()
            gmax.append(float(d.max()))
            gmean.append(float(d.mean()))
    return {"frame_max_gap": max(gmax), "frame_mean_gap": max(gmean)}


CONTROLS = {"train": control_train, "serve": control_serve}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", action="store_true")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0)
    kind = cell.traffic["kind"]
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            t0 = time.perf_counter()
            run = cells.DRIVERS[kind](cell, seed, args.seconds, False, dev, t0)
            print(json.dumps({"seed": seed, "side": "program", **run.check(),
                              "e2e": run.e2e}), flush=True)
            del run
        t0 = time.perf_counter()
        out = CONTROLS[kind](cell, seed, dev)
        print(json.dumps({"seed": seed, "side": "control", **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        cells._free(dev)


if __name__ == "__main__":
    main()
