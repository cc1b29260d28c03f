"""Sweep rasterizer settings; print one JSON line per config.

    python -m tinysplat_torch.scripts.sweep_bench --configs sorted:8:128 mxu:8:128:64 ...
    python -m tinysplat_torch.scripts.sweep_bench --device cpu --n 2048 \
        --height 64 --width 96 --iters 1 --warmup 0

Port of the JAX package's ``scripts/sweep_bench.py``, with its flags and
defaults. Times only the differentiable render (forward and backward of
``sum(rgb) + sum(depth)`` on the bench scene) for each config
``grad_reduce:tpb:chunk[:tile_x]``, all at ``max_per_tile`` 4096: one call,
``--warmup`` more, then ``--iters`` on the host clock with the device
synchronized at both ends. Each line holds ``config``, ``ms_per_iter`` and
``msplats_s``; with ``--diag`` instead the render's binning counters
(``intersections``, ``dup_dropped``, ``tile_dropped``) of one gradient. A
config that raises prints ``{"config", "error"}`` and the sweep goes on.

The port reads ``grad_reduce`` (``"mxu"`` sums through the segment-sum
kernel K3), ``chunk`` (it rounds the binning budgets and pads the entry
list) and ``tile_x``. It does not read ``tpb``: tiles per block is a TPU
grid-step setting with no counterpart in the CUDA kernels, so every line
carries ``"tiles_per_block_read": false`` and a sweep over ``tpb`` measures
nothing.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence

from ..utils.device import resolve_device, synchronize
from .profile_bench import bench_scene, render_grad


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sweep rasterizer settings")
    p.add_argument("--n", type=int, default=1 << 18)
    p.add_argument("--height", type=int, default=1066)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--configs", nargs="+",
                   default=["sorted:8:128", "segment:8:128", "scatter:8:128"])
    p.add_argument("--dup-capacity", type=int, default=1_280_000)
    p.add_argument("--span-capacity", type=int, default=786_432)
    p.add_argument("--diag", action="store_true",
                   help="print intersection/span diagnostics per config")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Returns the printed lines, one dict per config."""
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    state, cam, background = bench_scene(args.n, args.height, args.width, dev)
    lines = []
    for cfg in args.configs:
        parts = cfg.split(":")
        gr, tpb, chunk = parts[0], int(parts[1]), int(parts[2])
        tile_x = int(parts[3]) if len(parts) > 3 else 0
        grad = render_grad(state, cam, background, args.height, args.width,
                           dup_capacity=args.dup_capacity, span_capacity=args.span_capacity,
                           max_per_tile=4096, grad_reduce=gr, chunk=chunk,
                           tiles_per_block=tpb, tile_x=tile_x)
        try:
            if args.diag:
                _, d = grad()
                line = {"config": cfg, "diag": {k: int(v) for k, v in d.items()}}
            else:
                grad()
                for _ in range(args.warmup):
                    grad()
                synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    grad()
                synchronize(dev)
                dt = time.perf_counter() - t0
                line = {"config": cfg, "ms_per_iter": round(dt / args.iters * 1000.0, 2),
                        "msplats_s": round(args.n * args.iters / dt / 1e6, 3)}
        except Exception as e:
            line = {"config": cfg,
                    "error": (str(e) or type(e).__name__).splitlines()[0][:200]}
        line["tiles_per_block_read"] = False
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
