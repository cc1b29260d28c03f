"""Few-view A/B: --regularize-diffusion on vs off.

    python -m tinysplat_torch.scripts.diffusion_ab --prior-dir DIR [--out AB.json]
    python -m tinysplat_torch.scripts.diffusion_ab --device cpu --prior-dir DIR \
        --size 32 --iters 4 --diffusion-start 1 --init-points 200 --capacity 512 \
        --out AB.json

Port of the JAX package's ``scripts/diffusion_ab.py``, with its flags,
defaults and JSON keys. Trains the SAME few-view scene twice from the same
init: once plain, once with diffusion-guided novel-view regularization
through the prior in ``--prior-dir`` (``train_diffusion_prior``), and
reports held-out PSNR / SSIM of both arms and their difference. Train and
eval views interleave on one orbit of the quality bench's GT scene (at
40 x 400), rendered at ``--size`` (the prior's image size) through the
compositing kernel. The guided arm refreshes its synthetic views every 400
steps from ``--diffusion-start`` until 10/12 of ``--iters``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from ..config import Config
from ..data.synthetic import orbit_cameras
from ..models.gaussians import init_from_pcd
from ..scene import Scene
from ..train_loop import Trainer
from ..utils.device import resolve_device
from .quality_bench import gt_renderer, make_gt_scene, make_gt_state


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Few-view training with and without the prior")
    p.add_argument("--prior-dir", default=os.path.join(tempfile.gettempdir(), "diffusion_prior"))
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--train-views", type=int, default=6)
    p.add_argument("--eval-views", type=int, default=6)
    p.add_argument("--size", type=int, default=128,
                   help="image side; must equal the prior's image size")
    p.add_argument("--init-points", type=int, default=4000)
    p.add_argument("--capacity", type=int, default=1 << 15)
    p.add_argument("--lambda-diffusion", type=float, default=0.5)
    p.add_argument("--diffusion-start", type=int, default=600)
    p.add_argument("--out", default="DIFFUSION_AB_r05.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def arm_config(args, use_diffusion: bool) -> Config:
    """One arm's training configuration."""
    return Config(
        rasterizer="auto", sh_degree=2, max_iter=args.iters,
        eval_interval=0, densify_end=args.iters * 10 // 15,
        regularize_diffusion=use_diffusion,
        diffusion_model_dir=args.prior_dir if use_diffusion else "",
        lambda_diffusion=args.lambda_diffusion,
        regularize_diffusion_start=args.diffusion_start,
        regularize_diffusion_end=args.iters * 10 // 12,
        interval_diffusion=400,
    )


def main(argv: Optional[Sequence[str]] = None, history: Optional[dict] = None) -> dict:
    """``history``, when given, receives the GT views' dropped entries
    (``gt_dropped``) and each arm's ``Trainer`` under ``plain`` and
    ``guided``."""
    args = arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("diffusion_ab")
    dev = resolve_device(args.device)
    history = {} if history is None else history

    S = args.size
    rng = np.random.default_rng(args.seed)
    means, log_scales, quats, colors, opac = make_gt_scene(n_clusters=40, per_cluster=400,
                                                           seed=args.seed)
    n = len(means)
    gt_state = make_gt_state(means, log_scales, quats, colors, opac, 1, dev)
    render_gt = gt_renderer(gt_state, 1, "auto", dup_capacity=24 * n, span_capacity=10 * n,
                            max_per_tile=16384)

    total = args.train_views + args.eval_views
    cams = orbit_cameras(total, width=S, height=S, radius=3.2, fov=0.9)
    history["gt_dropped"] = []
    for c in cams:
        rgb, _, dropped = render_gt(c.params(dev), S, S)
        history["gt_dropped"].append(dropped)
        c._image = rgb.cpu().numpy()
    if any(history["gt_dropped"]):
        log.warning("GT views dropped %s intersections", history["gt_dropped"])
    del gt_state
    train_cams = cams[0::2][:args.train_views]
    eval_cams = cams[1::2][:args.eval_views]

    lo, hi = means.min(axis=0), means.max(axis=0)
    init_xyz = rng.uniform(lo, hi, size=(args.init_points, 3)).astype(np.float32)
    init_rgb = rng.uniform(0.2, 0.8, size=(args.init_points, 3))

    def run_arm(use_diffusion: bool):
        state = init_from_pcd(init_xyz, init_rgb * 255.0, sh_degree=2, capacity=args.capacity,
                              seed=args.seed, device=dev)
        trainer = Trainer(arm_config(args, use_diffusion),
                          Scene(list(train_cams), seed=args.seed), state)
        trainer.eval_cameras = list(eval_cams)
        history["guided" if use_diffusion else "plain"] = trainer
        t0 = time.perf_counter()
        trainer.run(args.iters)
        ev = trainer.evaluate()
        return {"eval_psnr": round(ev["eval_psnr"], 2),
                "eval_ssim": round(ev["eval_ssim"], 4),
                "train_minutes": round((time.perf_counter() - t0) / 60, 1)}

    log.info("arm A: plain few-view (%d train views)", len(train_cams))
    plain = run_arm(False)
    log.info("arm A: %s", plain)
    log.info("arm B: --regularize-diffusion with prior %s", args.prior_dir)
    guided = run_arm(True)
    log.info("arm B: %s", guided)

    out = {
        "metric": "diffusion_guidance_psnr_delta",
        "value": round(guided["eval_psnr"] - plain["eval_psnr"], 2),
        "unit": "dB (guided - plain, held-out)",
        "plain": plain,
        "guided": guided,
        "prior_dir": args.prior_dir,
        "train_views": len(train_cams),
        "eval_views": len(eval_cams),
        "iters": args.iters,
        "resolution": [S, S],
    }
    print(json.dumps(out), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
