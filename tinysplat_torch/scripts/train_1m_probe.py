"""1M-splat training probe: the ``Trainer`` at the reference framework's cap.

    python -m tinysplat_torch.scripts.train_1m_probe [--steps 100] [--out P.json]
    python -m tinysplat_torch.scripts.train_1m_probe --device cpu --n 2000 \
        --steps 2 --height 48 --width 64 --cameras 2

Port of the JAX package's ``scripts/train_1m_probe.py``, with its flags,
defaults and JSON keys. The reference framework caps models at 1e6 splats;
this runs the real host training loop (budget retune, densify cadence, NaN
guard, metrics) for a short window with 1M live splats from step 0 and
reports the loss trajectory as PSNR, the tuned binning budgets with the last
step's intersections and dropped entries, and steps/s. Ground truth is the
cloud's own render; the trainee is the same cloud with jittered positions,
a late-training state at full scale.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from ..config import Config
from ..data.synthetic import orbit_cameras, random_gaussian_cloud
from ..models.gaussians import GaussianState, grow_capacity
from ..scene import Scene
from ..train_loop import Trainer
from ..utils.device import resolve_device
from .quality_bench import gt_renderer, make_gt_state

NOISE_SEED = 7  # the means jitter's generator


def _example_state(n: int, capacity: int, sh_degree: int = 3, seed: int = 0,
                   scale_range=(0.01, 0.08), device="cuda") -> GaussianState:
    """``random_gaussian_cloud(n)`` as a state of ``capacity`` slots: its
    colours as ``init_from_pcd`` turns them into SH, its own scales,
    rotations and opacities, dead slots after the first ``n``."""
    means, log_scales, quats, colors, opac = random_gaussian_cloud(
        n, seed=seed, scale_range=scale_range)
    state = make_gt_state(means, log_scales, quats, colors, opac, sh_degree, device)
    return grow_capacity(state, capacity) if capacity > n else state


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="The Trainer at 1M live splats")
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--height", type=int, default=1056)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--cameras", type=int, default=8)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None, noise: Optional[torch.Tensor] = None,
         history: Optional[dict] = None) -> dict:
    """``noise``: the (n, 3) unit-normal draw of the means jitter (default
    from a ``torch.Generator`` seeded ``NOISE_SEED`` on the device).
    ``history``, when given, receives the ``trainer`` and the per-step
    ``losses``."""
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    H, W = args.height, args.width

    # GT = the cloud's own clean render, so that the loss has signal.
    gt_state = _example_state(args.n, args.n, scale_range=(0.002, 0.008), device=dev)
    cams = orbit_cameras(args.cameras, width=W, height=H)
    render_gt = gt_renderer(gt_state, 3, "auto", dup_capacity=4_000_000,
                            span_capacity=3_200_000, max_per_tile=8192)
    dropped_total = 0
    for cam in cams:
        rgb, _, dropped = render_gt(cam.params(dev), H, W)
        dropped_total += dropped
        cam._image = rgb.cpu().numpy()
    del gt_state
    print(f"GT rendered: {dropped_total} dropped entries", flush=True)

    # Trainee: the SAME cloud with jittered positions.
    state = _example_state(args.n, args.n, scale_range=(0.002, 0.008), device=dev)
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
        noise = torch.randn(state.params.means.shape, generator=gen, device=dev)
    with torch.no_grad():
        state.params.means += 0.003 * noise.to(dev)

    # warmup_densify > steps: a fixed 1M capacity (the cap is the test).
    cfg = Config(rasterizer="auto", sh_degree=3, max_iter=args.steps,
                 eval_interval=0, warmup_densify=args.steps + 1)
    trainer = Trainer(cfg, Scene(cams), state)
    trainer.eval_cameras = cams[:1]

    ev0 = trainer.evaluate()
    losses = []
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):  # Trainer.run, one step at a time
        trainer.run(step)
        losses.append(trainer.last_metrics["loss"].detach())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if history is not None:
        history.update(trainer=trainer, losses=[float(x) for x in losses])
    ev1 = trainer.evaluate()
    diag = trainer._last_diag
    diag = [int(x) for x in diag] if diag else [-1, -1, -1]
    out = {
        "metric": "train_1m_probe",
        "value": round(args.steps / dt, 3),
        "unit": "steps/s at 1M live splats",
        "n_splats": args.n,
        "steps": args.steps,
        "psnr_start": round(float(ev0["eval_psnr"]), 2),
        "psnr_end": round(float(ev1["eval_psnr"]), 2),
        "n_intersections": diag[0],
        "dup_dropped": diag[1],
        "tile_dropped": diag[2],
        "tuned_budgets": {"dup_capacity": int(trainer.cfg.dup_capacity),
                          "span_capacity": int(trainer.cfg.span_capacity),
                          "max_per_tile": int(trainer.cfg.max_per_tile)},
        "resolution": [H, W],
        "gt_dropped": dropped_total,
    }
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
