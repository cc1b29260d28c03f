"""Profile the bench scene's differentiable render; print the top ops.

    python -m tinysplat_torch.scripts.profile_bench [--n 262144] [--iters 3] [--top 30]
    python -m tinysplat_torch.scripts.profile_bench --device cpu --n 2048 \
        --height 64 --width 96 --iters 1

Port of the JAX package's ``scripts/profile_bench.py``, with its flags and
defaults (its own budgets: ``dup_capacity`` 1,280,000, ``max_per_tile``
2048, 16-px tiles). The gradient of ``sum(rgb) + sum(depth)`` by autograd
runs once to warm up; the render's binning counters of that call
(intersections, entries dropped by ``dup_capacity`` and by
``max_per_tile``) are printed, so the profile says what it profiled. Then
``--iters`` gradients run under ``torch.profiler`` (the device synchronized
at the end), and the window's top ops (the card's kernels by device time;
on the CPU the ops by self time) and its kernel-busy share are printed
(``utils/profiling.py``). The Chrome trace goes to ``--logdir``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Optional, Sequence

import torch

from ..data.synthetic import orbit_cameras
from ..models.gaussians import GaussianParams, GaussianState
from ..render import render
from ..utils import profiling
from ..utils.device import resolve_device, synchronize
from .train_1m_probe import _example_state

BENCH_SCALES = (0.002, 0.01)  # the bench scene's scale range


def default_logdir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def bench_scene(n: int, height: int, width: int, device):
    """The bench scene (``_example_state``, every slot live), its one orbit
    camera and a black background."""
    state = _example_state(n, n, scale_range=BENCH_SCALES, device=device)
    cam = orbit_cameras(1, width=width, height=height)[0].params(device)
    return state, cam, torch.zeros(3, device=device)


def render_grad(state: GaussianState, cam, background, height: int, width: int,
                **render_kw):
    """``grad()`` -> (the gradients of ``sum(rgb) + sum(depth)`` by
    parameter field, the render's binning counters) at SH degree 3."""
    leaves = GaussianParams(**{k: t.detach() for k, t in state.params.fields()})
    leaves.requires_grad_()
    tensors = [t for _, t in leaves.fields()]

    def grad():
        rgb, extras = render(leaves, state.alive, cam, height, width, 3, background,
                             **render_kw)
        loss = rgb.sum() + extras["depth"].sum()
        return torch.autograd.grad(loss, tensors), extras["binning"]

    return grad


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Profile the bench scene's render gradient")
    p.add_argument("--n", type=int, default=1 << 18)
    p.add_argument("--height", type=int, default=1066)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--dup-capacity", type=int, default=1_280_000)
    p.add_argument("--span-capacity", type=int, default=786_432)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--grad-reduce", default="scatter",
                   choices=["scatter", "sorted", "segment"])
    p.add_argument("--tpb", type=int, default=8)
    p.add_argument("--tile-x", type=int, default=0)
    p.add_argument("--logdir", default=None,
                   help="Chrome trace directory (default: tinysplat_torch_trace in the "
                        "temporary directory)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the printed table (``print_top_ops``' dict) with the
    ``binning`` counters, the ``kernel_busy_share`` and the ``logdir``."""
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    state, cam, background = bench_scene(args.n, args.height, args.width, dev)
    grad = render_grad(state, cam, background, args.height, args.width,
                       dup_capacity=args.dup_capacity, span_capacity=args.span_capacity,
                       max_per_tile=2048, grad_reduce=args.grad_reduce, chunk=args.chunk,
                       tiles_per_block=args.tpb, tile_x=args.tile_x)
    _, diag = grad()
    synchronize(dev)
    binning = {k: int(v) for k, v in diag.items()}
    print(f"binning of the profiled render: {binning}", flush=True)

    logdir = args.logdir or default_logdir("tinysplat_torch_trace")
    shutil.rmtree(logdir, ignore_errors=True)
    prof = profiling.window(grad, args.iters, dev, logdir)
    top = profiling.print_top_ops(prof, top=args.top, iters=args.iters)
    share = profiling.kernel_busy_share(prof)
    print(profiling.busy_share_line(share, f"profile window ({args.iters} iterations)"),
          flush=True)
    return dict(top, binning=binning, kernel_busy_share=share, logdir=logdir)


if __name__ == "__main__":
    main()
