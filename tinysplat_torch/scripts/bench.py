"""The headline benchmark: differentiable rasterization throughput on one card.

    python -m tinysplat_torch.scripts.bench                    # 262,144 splats, 1066x1600
    python -m tinysplat_torch.scripts.bench --grad-reduce mxu  # the reduction through K3
    python -m tinysplat_torch.scripts.bench --device cpu --n 2048 --height 64 \
        --width 96 --iters 2

Port of the JAX package's root ``bench.py``, with its flags, defaults and
JSON lines, plus ``--device``. It times the gradient of ``sum(rgb) +
sum(depth)`` by autograd through ``render`` (projection, SH at degree 3,
binning, the compositing kernel K1, its backward K2, and K3 under
``--grad-reduce mxu``) on the bench scene (``profile_bench.bench_scene``:
the synthetic cloud with every slot live, one orbit camera, a black
background): 5 warm-up gradients, then ``--iters`` on the host clock with
the device synchronized at both ends. The headline line is printed at once;
then ``make_train_step`` (the same budgets, an all-zero ground truth, no
depth) takes one untimed step and ``max(iters // 2, 5)`` timed ones, and
the final line repeats the headline with the train-step numbers.

Lines before the headline: the card's name and power limit, and the
binning counters of the first gradient (intersections, entries dropped by
``dup_capacity`` and by ``max_per_tile``), so that the run says what it
timed; the two JSON lines are the last. The kernels are built at their
first launch, inside the warm-up and the untimed step. With no card the
run prints ``{"metric", "error"}`` and exits 1 before any work; it never
falls back to the CPU.

``--tpb`` and ``--chunk`` are the JAX kernels' grid and DMA settings: the
port passes them to ``render``, which reads ``chunk`` (it rounds the
binning budgets) but not ``tiles_per_block``; both are reported in
``config`` as JAX reports them.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence, Tuple

import torch

from ..config import Config
from ..train import init_opt_state, make_train_step
from ..utils.device import gpu_name_and_limit, resolve_device, synchronize
from .profile_bench import bench_scene, render_grad

METRIC = "rasterize_fwd_bwd_throughput"
# BASELINE.md's estimate of the reference's gsplat CUDA path, fwd+bwd on a
# consumer GPU at this scene size (the reference publishes no number); not a
# figure of any H100.
BASELINE_MSPLATS_S = 25.0
WARMUP = 5
MAX_PER_TILE = 4096  # keeps every intersection of the bench scene (no per-tile cap in gsplat)
CONFIG_KEYS = ("tile_x", "grad_reduce", "chunk", "tiles_per_block", "dup_capacity",
               "span_capacity")  # the headline's "config", in the JAX bench's order


def budgets(n: int, dup_capacity: int = 0, span_capacity: int = 0) -> Tuple[int, int]:
    """(dup_capacity, span_capacity): the given values, or the JAX bench's
    tuned ones (760,000 and 786,432 at 2^18 splats, zero dropped entries
    with headroom) scaled linearly with ``n``."""
    scale = n / (1 << 18)
    return dup_capacity or int(760_000 * scale), span_capacity or int(786_432 * scale)


def render_kw(args: argparse.Namespace) -> dict:
    """``render``'s budgets and kernel settings under the bench's flags."""
    dup, span = budgets(args.n, args.dup_capacity, args.span_capacity)
    return dict(tile_x=args.tile_x, grad_reduce=args.grad_reduce, chunk=args.chunk,
                tiles_per_block=args.tpb, dup_capacity=dup, span_capacity=span,
                max_per_tile=MAX_PER_TILE)


def train_config(args: argparse.Namespace) -> Config:
    """The train step's ``Config`` at the bench's budgets and kernel settings."""
    kw = render_kw(args)
    del kw["chunk"]  # not a Config field: the step renders at render's default, as in JAX
    return Config(rasterizer="auto", sh_degree=3, **kw)


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Headline benchmark: render fwd+bwd and the "
                                            "train step on the bench scene")
    p.add_argument("--n", type=int, default=1 << 18)
    p.add_argument("--height", type=int, default=1066)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--grad-reduce", default="scatter",
                   choices=["scatter", "sorted", "segment", "mxu"])
    p.add_argument("--tpb", type=int, default=8, help="tiles per Pallas block")
    p.add_argument("--tile-x", type=int, default=64,
                   help="Pallas tile width px (height fixed 16)")
    p.add_argument("--dup-capacity", type=int, default=0,
                   help="0 = auto-scale the tuned default with --n")
    p.add_argument("--span-capacity", type=int, default=0)
    p.add_argument("--chunk", type=int, default=128, help="pallas DMA window")
    p.add_argument("--headline-only", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None, history: Optional[dict] = None) -> dict:
    """Returns the last line printed, as a dict. ``history``, when given,
    receives the first gradient's ``binning`` counters, the first train
    step's ``train_binning`` and, on the card, ``memory``: the peak of
    device memory after the first gradient and after the timed ones, the
    memory in use before and after the timed ones, and the peak count of
    the allocator's large blocks."""
    args = arg_parser().parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(json.dumps({"metric": METRIC, "error": str(e)}), flush=True)
        raise SystemExit(1) from e
    history = {} if history is None else history
    on_card = dev.type == "cuda"
    if on_card:
        print(gpu_name_and_limit(), flush=True)
    n, H, W = args.n, args.height, args.width
    kw = render_kw(args)
    state, cam, background = bench_scene(n, H, W, dev)
    grad = render_grad(state, cam, background, H, W, **kw)

    # Warm-up (the kernels build at the first launch); no gradient is kept
    # from one call to the next.
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    history["binning"] = {k: int(v) for k, v in grad()[1].items()}
    if on_card:
        first_peak = torch.cuda.max_memory_allocated(dev)
    for _ in range(WARMUP - 1):
        grad()
    synchronize(dev)
    if on_card:
        rest_before = torch.cuda.memory_allocated(dev)
    print(f"binning of the timed render gradient: {history['binning']}", flush=True)

    t0 = time.perf_counter()
    for _ in range(args.iters):
        grad()
    synchronize(dev)
    dt = time.perf_counter() - t0
    if on_card:
        history["memory"] = {
            "first_peak": first_peak, "run_peak": torch.cuda.max_memory_allocated(dev),
            "rest_before": rest_before, "rest_after": torch.cuda.memory_allocated(dev),
            "large_blocks": torch.cuda.memory_stats(dev)["allocation.large_pool.peak"]}
    msplats_s = n * args.iters / dt / 1e6

    # The headline goes out now: a run cut during the train step keeps it.
    headline = {
        "metric": METRIC,
        "value": round(msplats_s, 3),
        "unit": "Msplats/s",
        "vs_baseline": round(msplats_s / BASELINE_MSPLATS_S, 3),
        "n_splats": n,
        "resolution": [H, W],
        "config": {k: kw[k] for k in CONFIG_KEYS},
    }
    print(json.dumps(headline), flush=True)
    if args.headline_only:
        return headline

    # The full train step (render, L1 + DSSIM, Adam, the densify
    # accumulator): the time a user's wall clock sees a step, and rays/s.
    cfg = train_config(args)
    tstep = make_train_step(cfg, H, W)
    opt = init_opt_state(cfg, state)
    gt = torch.zeros((H, W, 3), device=dev)
    generator = torch.Generator(device=dev)

    def step(st, i):
        generator.manual_seed(0)  # one background draw for every step, as JAX's PRNGKey(0)
        return tstep(st, opt, cam, gt, None, i, generator=generator)

    out = step(state, 0)
    st = out.state
    synchronize(dev)
    history["train_binning"] = {k: int(out.metrics[k]) for k in (
        "n_intersections", "n_dup_dropped", "n_tile_dropped")}
    full_iters = max(args.iters // 2, 5)
    t0 = time.perf_counter()
    for i in range(full_iters):
        st = step(st, i + 1).state
    synchronize(dev)
    steps_s = full_iters / (time.perf_counter() - t0)

    # The final line repeats the headline with the train-step numbers.
    record = {**headline,
              "train_step_ms": round(1000.0 / steps_s, 1),
              "train_steps_per_s": round(steps_s, 2),
              "rays_per_s": round(steps_s * H * W, 0)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
