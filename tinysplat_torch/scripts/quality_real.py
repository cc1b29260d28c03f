"""Real-photo end-to-end quality benchmark.

    python -m tinysplat_torch.scripts.quality_real [--iters 4000] [--out Q.json]
    python -m tinysplat_torch.scripts.quality_real --device cpu \
        --scene-dir /tmp/fixture_copy --holdout 4 --iters 4 --eval-every 2

Port of the JAX package's ``scripts/quality_real.py``, with its flags,
defaults and JSON keys. The complete real-data path on photographs:

  1. when ``<scene-dir>/sparse/0/images.bin`` is absent, write a dense
     multi-view capture there (``make_real_fixture``: crops of a real
     photograph on three planes, OPENCV cameras with distortion);
  2. load it through the COLMAP loader and undistortion (``data.Dataset``),
     cameras sorted by name, every ``--holdout``-th held out;
  3. initialize from the SfM points and attach ``--regularize-depth`` maps
     from ``DepthEstimator``'s offline ``sparse_interp`` backend, cached in
     ``<scene-dir>/depths`` (the tool WRITES into the scene directory: point
     it at a copy of a capture you want to keep unchanged);
  4. train with densification over a black background (the capture's own:
     a random training background on large black regions builds a
     fragmented curtain of splats) and evaluate held-out PSNR / SSIM.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time
from typing import Optional, Sequence

from ..config import Config
from ..data.dataset import Dataset
from ..depthest import DepthEstimator
from ..models.gaussians import init_from_pcd
from ..scene import Scene
from ..train_loop import Trainer
from ..utils.device import resolve_device
from . import make_real_fixture


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Real-photo held-out quality benchmark")
    p.add_argument("--iters", type=int, default=4000)
    p.add_argument("--views", type=int, default=28)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=352)
    p.add_argument("--per-plane-points", type=int, default=500)
    p.add_argument("--holdout", type=int, default=7)
    p.add_argument("--capacity", type=int, default=1 << 16)
    p.add_argument("--no-depth-reg", action="store_true")
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--scene-dir", default=os.path.join(tempfile.gettempdir(), "real_scene"))
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("quality_real")
    dev = resolve_device(args.device)

    # --- 1. a dense real-photo capture -------------------------------------
    if not os.path.exists(os.path.join(args.scene_dir, "sparse/0/images.bin")):
        log.info("generating %d-view %dx%d capture at %s", args.views, args.width,
                 args.height, args.scene_dir)
        make_real_fixture.main(out_root=args.scene_dir, n_views=args.views, width=args.width,
                               height=args.height, per_plane=args.per_plane_points)

    # --- 2. the production data path ---------------------------------------
    dataset = Dataset(os.path.join(args.scene_dir, "sparse/0"),
                      os.path.join(args.scene_dir, "images"), lazy_images=False)
    cams = sorted(dataset.cameras, key=lambda c: c.name)
    train_cams = [c for i, c in enumerate(cams) if i % args.holdout != 0]
    eval_cams = [c for i, c in enumerate(cams) if i % args.holdout == 0]
    W, H = cams[0].width, cams[0].height
    log.info("loaded %d cams (%d train / %d eval) at %dx%d, %d SfM points", len(cams),
             len(train_cams), len(eval_cams), W, H, len(dataset.pcd.xyz))

    scene = Scene(train_cams)
    depth_reg = not args.no_depth_reg
    if depth_reg:
        DepthEstimator(scene, pcd=dataset.pcd,
                       depths_path=os.path.join(args.scene_dir, "depths"),
                       model_name="sparse_interp")

    # --- 3. train ------------------------------------------------------------
    state = init_from_pcd(dataset.pcd.xyz, dataset.pcd.colors, sh_degree=3,
                          capacity=args.capacity, device=dev)
    cfg = Config(rasterizer="auto", sh_degree=3, max_iter=args.iters,
                 eval_interval=0, densify_end=args.iters * 10 // 15,
                 regularize_depth=depth_reg, background="black")
    trainer = Trainer(cfg, scene, state)
    trainer.eval_cameras = eval_cams

    t0 = time.perf_counter()
    eval_history = []
    while trainer.step < args.iters:
        trainer.run(min(trainer.step + args.eval_every, args.iters))
        ev_i = trainer.evaluate()
        eval_history.append({"step": trainer.step,
                             "minutes": round((time.perf_counter() - t0) / 60, 2),
                             "psnr": round(ev_i["eval_psnr"], 2)})
    dt = time.perf_counter() - t0

    ev = trainer.evaluate()
    out = {
        "metric": "real_photo_heldout_psnr",
        "value": round(ev["eval_psnr"], 2),
        "unit": "dB",
        "eval_ssim": round(ev["eval_ssim"], 4),
        "data_path": "COLMAP bin + OPENCV undistortion + SfM-point init",
        "depth_reg": depth_reg,
        "depth_model": "sparse_interp" if depth_reg else None,
        "texture_source": "matplotlib grace_hopper.jpg (real photograph)",
        "eval_history": eval_history,
        "iters": args.iters,
        "steps_per_s": round(args.iters / dt, 2),
        "train_minutes": round(dt / 60, 1),
        "num_splats": int(trainer.state.num_live()),
        "views": len(cams),
        "resolution": [H, W],
    }
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
