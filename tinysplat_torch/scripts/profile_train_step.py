"""Profile the whole train step (render, L1 + DSSIM, Adam, the densify
accumulator) and print the top ops: the render's forward and backward are
``profile_bench``'s; this shows the rest of the step beside them.

    python -m tinysplat_torch.scripts.profile_train_step [--n 262144] [--top 30]
    python -m tinysplat_torch.scripts.profile_train_step --device cpu --n 2048 \
        --height 64 --width 96 --iters 1

Port of the JAX package's ``scripts/profile_train_step.py``, with its flags
and defaults: ``make_train_step`` at SH degree 3 with the budgets
``dup_capacity`` 760,000 n / 2^18, ``span_capacity`` 786,432 n / 2^18 and
``max_per_tile`` 4096, an all-zero ground truth and no depth; one warm-up
step, then steps 1..iters under ``torch.profiler``. The random background
comes from a ``torch.Generator`` seeded 0 at every step, as the JAX script
passes ``PRNGKey(0)`` to every step. The table and the kernel-busy share
are ``utils/profiling.py``'s.
"""
from __future__ import annotations

import argparse
import shutil
from typing import Optional, Sequence

import torch

from ..config import Config
from ..data.synthetic import orbit_cameras
from ..train import init_opt_state, make_train_step
from ..utils import profiling
from ..utils.device import resolve_device, synchronize
from .bench import budgets
from .profile_bench import BENCH_SCALES, default_logdir
from .train_1m_probe import _example_state


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Profile the full train step")
    p.add_argument("--n", type=int, default=1 << 18)
    p.add_argument("--height", type=int, default=1066)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--logdir", default=None,
                   help="Chrome trace directory (default: tinysplat_torch_trace_step in the "
                        "temporary directory)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the printed table (``print_top_ops``' dict) with the
    ``kernel_busy_share``, the ``logdir`` and the last step's ``loss``."""
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    H, W = args.height, args.width
    dup, span = budgets(args.n)
    cfg = Config(rasterizer="auto", sh_degree=3, dup_capacity=dup, span_capacity=span,
                 max_per_tile=4096)
    state = _example_state(args.n, args.n, scale_range=BENCH_SCALES, device=dev)
    opt = init_opt_state(cfg, state)
    cam = orbit_cameras(1, width=W, height=H)[0].params(dev)
    gt = torch.zeros((H, W, 3), device=dev)
    generator = torch.Generator(device=dev)
    tstep = make_train_step(cfg, H, W)
    run = {"state": state, "step": 0, "out": None}

    def step():
        generator.manual_seed(0)
        out = tstep(run["state"], opt, cam, gt, None, run["step"], generator=generator)
        run.update(state=out.state, step=run["step"] + 1, out=out)

    step()
    synchronize(dev)

    logdir = args.logdir or default_logdir("tinysplat_torch_trace_step")
    shutil.rmtree(logdir, ignore_errors=True)
    prof = profiling.window(step, args.iters, dev, logdir)
    top = profiling.print_top_ops(prof, top=args.top, iters=args.iters)
    share = profiling.kernel_busy_share(prof)
    print(profiling.busy_share_line(share, f"profile window ({args.iters} steps)"),
          flush=True)
    return dict(top, kernel_busy_share=share, logdir=logdir,
                loss=float(run["out"].metrics["loss"]))


if __name__ == "__main__":
    main()
