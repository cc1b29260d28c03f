"""Held-out evaluation CLI: checkpoint + dataset -> PSNR / SSIM JSON.

    # a COLMAP dataset, every k-th camera (as train_cli --eval-holdout):
    python -m tinysplat_torch.scripts.evaluate ckpt.npz --dataset-dir datasets/truck \
        --holdout 8
    # or the synthetic scene of train_cli --synthetic:
    python -m tinysplat_torch.scripts.evaluate ckpt.npz --synthetic [--device cpu]

Port of the JAX package's ``scripts/evaluate.py``, with its flags, defaults
and JSON keys: renders every selected camera from the checkpoint (either
package's ``.npz``) over black and prints one JSON line,
``{"checkpoint", "views", "psnr", "ssim", "per_view": [...]}``. The
rasterizer names are the port's (``auto``, ``cuda``, ``dense``). A frame is
rendered at the default binning budgets; when that drops entries, it is
rendered again at budgets that hold them all (the JAX script scores the
truncated frame), so a score is always that of the whole model.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..io.checkpoint import load_model
from ..ops.ssim import psnr, ssim
from ..render import render
from ..utils.device import resolve_device

log = logging.getLogger(__name__)

MAX_PER_TILE = 16384  # the trainer's budget retune stops here too


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Held-out PSNR / SSIM of a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("--dataset-dir", default=None)
    p.add_argument("--colmap-path", default=None)
    p.add_argument("--images-path", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--holdout", type=int, default=1, help="evaluate every k-th camera (1 = all)")
    p.add_argument("--rasterizer", default="auto")
    p.add_argument("--max-views", type=int, default=0, help="0 = no cap")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def eval_cameras(args, device):
    """The cameras the flags select, in dataset order."""
    if args.synthetic:
        # The GT scene train_cli --synthetic trains against.
        from ..train_cli import build_scene

        scene, _, _ = build_scene(Config(synthetic=True), device)
        cams = scene.cameras
    else:
        from ..data.dataset import Dataset

        colmap = args.colmap_path or os.path.join(args.dataset_dir, "sparse", "0")
        images = args.images_path or os.path.join(args.dataset_dir, "images")
        cams = Dataset(colmap, images).cameras
    cams = cams[::max(args.holdout, 1)]
    return cams[:args.max_views] if args.max_views else cams


@torch.no_grad()
def frame(state, cam, rasterizer, device):
    """The model's (H, W, 3) frame of ``cam`` over black, no entry dropped."""
    cp = cam.params(device)
    bg = torch.zeros(3, device=device)

    def draw(**budgets):
        return render(state.params, state.alive, cp, cam.height, cam.width,
                      state.active_sh_degree, bg, rasterizer=rasterizer, **budgets)

    rgb, extras = draw()
    diag = extras.get("binning")
    if diag is not None and (int(diag["dup_dropped"]) or int(diag["tile_dropped"])):
        total = int(diag["intersections"])
        log.warning("%s: the default budgets dropped %d + %d of %d entries; rendering "
                    "again at budgets that hold them", cam.name, int(diag["dup_dropped"]),
                    int(diag["tile_dropped"]), total)
        rgb, extras = draw(dup_capacity=2 * total, span_capacity=2 * total,
                           max_per_tile=MAX_PER_TILE)
        diag = extras["binning"]
        if int(diag["dup_dropped"]) or int(diag["tile_dropped"]):
            raise RuntimeError(f"{cam.name}: entries dropped even at {MAX_PER_TILE} per tile: "
                               f"{diag}")
    return rgb


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cams = eval_cameras(args, dev)
    state = load_model(args.checkpoint, device=dev)
    per_view = []
    for cam in cams:
        gt = torch.as_tensor(cam.get_original_image((cam.width, cam.height)), device=dev)
        rgb = frame(state, cam, args.rasterizer, dev)
        per_view.append({
            "name": cam.name or f"cam{len(per_view)}",
            "psnr": round(float(psnr(rgb, gt)), 3),
            "ssim": round(float(ssim(rgb, gt)), 4),
        })
    out = {
        "checkpoint": args.checkpoint,
        "views": len(per_view),
        "psnr": round(float(np.mean([v["psnr"] for v in per_view])), 3),
        "ssim": round(float(np.mean([v["ssim"] for v in per_view])), 4),
        "per_view": per_view,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
