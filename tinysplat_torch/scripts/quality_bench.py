"""Full-scale quality benchmark: train a real-sized scene, report held-out
PSNR / SSIM, steps/s and the minutes to a target PSNR.

    python -m tinysplat_torch.scripts.quality_bench [--iters 7000] [--out Q.json]
    python -m tinysplat_torch.scripts.quality_bench --device cpu --iters 6 \
        --width 32 --height 16 --cameras 2 --holdout 2 --init-points 200 \
        --capacity 512 --eval-every 3 --gt-rasterizer dense --eval-scales 0.5

Port of the JAX package's ``scripts/quality_bench.py``, with its flags,
defaults and JSON keys. Ground truth comes from a structured synthetic
splat scene (``make_gt_scene``: clustered ellipsoid shells, a ground slab
and a textured dome; numpy draws equal to the JAX script's) rendered at
1600x1056 from 36 orbit cameras; the trainee starts from a uniform random
cloud in the scene's box, so no ground-truth position or colour reaches it.
Every GT frame must bin with nothing dropped.

The GT backend is ``--gt-rasterizer`` (default ``cuda``: the compositing
kernel on the card). The JAX script's default, the XLA ``tiled`` backend,
has no counterpart here; the kernel is held against its plain version
instead (chip_smoke.py, phase 13). The JSON line records the backend.
Held-out evaluation runs every ``--eval-every`` steps on the training clock;
a boundary that lands on an opacity reset is deferred past the recovery
window and marked ``post_opacity_reset``. The trained model is written to
``quality_model.npz`` in the temporary directory.
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
import torch

from ..config import Config
from ..data.synthetic import orbit_cameras
from ..io.checkpoint import save_checkpoint
from ..models.gaussians import GaussianParams, GaussianState, init_from_pcd
from ..ops.sh import num_sh_bases
from ..ops.ssim import psnr
from ..render import render
from ..scene import Scene
from ..train_loop import Trainer
from ..utils.color import RGB2SH
from ..utils.device import resolve_device

# Explicit GT budgets: a silently truncated GT frame (the default 8N
# intersections are far under a dense shell scene's ~2.5M) would poison the
# benchmark, training fitting truncated frames while eval renders the model.
GT_DUP_CAPACITY = 6_000_000
GT_SPAN_CAPACITY = 2_000_000


def make_gt_scene(n_clusters=70, per_cluster=700, seed=0):
    """Structured multi-object splat scene: opaque ellipsoid SHELLS (surface
    splats, like real captured geometry; a volumetric fuzz is view-
    inconsistent and cannot be generalized from any finite camera set), a
    thin ground slab and an enclosing textured dome. Returns float32 means,
    log-scales, quats, colours in [0, 1] and opacity logits."""
    rng = np.random.default_rng(seed)
    means, scales, colors, opacs, quats = [], [], [], [], []
    centers = rng.uniform(-1.0, 1.0, size=(n_clusters, 3)) * np.array([1.2, 0.5, 1.2])
    for c in centers:
        k = per_cluster
        semi = rng.uniform(0.06, 0.28, size=3)  # ellipsoid semi-axes
        u = rng.normal(size=(k, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        pts = c + u * semi  # on the shell
        base = rng.uniform(0.15, 0.95, size=3)
        col = np.clip(base + rng.normal(scale=0.06, size=(k, 3)), 0, 1)
        means.append(pts)
        # Splat footprint ~ shell sampling distance so the surface closes.
        area = 4 * np.pi * (semi.prod()) ** (2 / 3)
        r = np.sqrt(area / k) * 1.2
        scales.append(np.log(np.full((k, 3), r) * rng.uniform(0.7, 1.4, (k, 3))))
        colors.append(col)
        opacs.append(rng.uniform(2.0, 4.0, size=(k, 1)))  # opaque surface
        q = rng.normal(size=(k, 4))
        quats.append(q / np.linalg.norm(q, axis=1, keepdims=True))
    # Ground slab
    k = 12_000
    pts = np.stack([rng.uniform(-1.8, 1.8, k), np.full(k, 0.75)
                    + rng.normal(scale=0.01, size=k), rng.uniform(-1.8, 1.8, k)], axis=1)
    means.append(pts)
    scales.append(np.log(np.stack([rng.uniform(0.015, 0.04, k),
                                   rng.uniform(0.002, 0.004, k),
                                   rng.uniform(0.015, 0.04, k)], axis=1)))
    g = rng.uniform(0.25, 0.45, size=(k, 1))
    colors.append(np.concatenate([g, g * rng.uniform(0.9, 1.1, (k, 1)), g * 0.8], axis=1))
    opacs.append(rng.uniform(2.0, 4.0, size=(k, 1)))
    q = rng.normal(size=(k, 4))
    quats.append(q / np.linalg.norm(q, axis=1, keepdims=True))
    # Enclosing textured dome: full image coverage from every orbit camera.
    # A scene with large pure-background regions is pathological for the
    # random-background training loss (the model builds per-camera black
    # curtains that destroy interpolated views); real captures have full
    # coverage, so the benchmark should too.
    k = 30_000
    u = rng.normal(size=(k, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = u * 6.5
    means.append(pts)
    r = np.sqrt(4 * np.pi * 6.5**2 / k) * 1.3
    scales.append(np.log(np.full((k, 3), r) * rng.uniform(0.8, 1.3, (k, 3))))
    base = rng.uniform(0.3, 0.8, size=(k, 3))
    # Low-frequency color bands so the dome carries learnable structure.
    bands = 0.5 + 0.5 * np.sin(pts[:, 1:2] * 2.0 + pts[:, 0:1])
    colors.append(np.clip(base * bands, 0, 1))
    opacs.append(rng.uniform(2.5, 4.0, size=(k, 1)))
    q = rng.normal(size=(k, 4))
    quats.append(q / np.linalg.norm(q, axis=1, keepdims=True))
    return (np.concatenate(means).astype(np.float32),
            np.concatenate(scales).astype(np.float32),
            np.concatenate(quats).astype(np.float32),
            np.concatenate(colors).astype(np.float32),
            np.concatenate(opacs).astype(np.float32))


def make_gt_state(means, log_scales, quats, colors, opac, sh_degree, device) -> GaussianState:
    """The GT scene as a state with every slot live: the colours as
    ``init_from_pcd`` turns them into SH, the scene's own scales, rotations
    and opacities (what the JAX scripts build with ``init_from_pcd`` and
    then overwrite, without its neighbour search for the scales)."""
    dev = resolve_device(device)
    n = len(means)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    params = GaussianParams(
        means=f32(means), colors_dc=RGB2SH(f32(colors * 255.0) / 255.0),
        colors_rest=torch.zeros((n, num_sh_bases(sh_degree) - 1, 3), device=dev),
        scales=f32(log_scales), quats=f32(quats), opacities=f32(opac))
    return GaussianState(params=params, alive=torch.ones(n, dtype=torch.bool, device=dev),
                         means_grad_accum=torch.zeros(n, device=dev),
                         active_sh_degree=torch.tensor(1, dtype=torch.int32, device=dev))


def gt_renderer(gt_state: GaussianState, sh_degree: int, rasterizer: str, **budgets):
    """``render_gt(cam_params, h, w)`` -> (rgb, depth, dropped entries):
    the GT scene over black at the explicit binning ``budgets``."""
    bg = torch.zeros(3, device=gt_state.alive.device)

    @torch.no_grad()
    def render_gt(cam_params, h, w):
        rgb, extras = render(gt_state.params, gt_state.alive, cam_params, h, w, sh_degree, bg,
                             rasterizer=rasterizer, **budgets)
        d = extras.get("binning", {"dup_dropped": 0, "tile_dropped": 0})
        return rgb, extras["depth"], int(d["dup_dropped"]) + int(d["tile_dropped"])

    return render_gt


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=7000)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--height", type=int, default=1056)  # 66 tile rows
    p.add_argument("--cameras", type=int, default=36)
    p.add_argument("--holdout", type=int, default=9)  # every 9th -> 4 eval cams
    p.add_argument("--init-points", type=int, default=16000)
    p.add_argument("--gt-max-per-tile", type=int, default=8192,
                   help="GT render per-tile budget; raise for small "
                        "resolutions where the dome collapses into few tiles")
    p.add_argument("--gt-rasterizer", default="cuda",
                   help="backend for GT frames (the port's: cuda, dense); trainee: auto")
    p.add_argument("--target-psnr", type=float, default=27.0)
    p.add_argument("--densify-strategy", default="default", choices=["default", "mcmc"])
    p.add_argument("--antialiased", action="store_true")
    p.add_argument("--capacity", type=int, default=1 << 17,
                   help="trainee splat capacity (MCMC fills it: smaller = faster steps)")
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--eval-scales", default="",
                   help="comma-separated extra held-out eval scales (e.g. '0.5,0.25'): "
                        "multi-scale PSNR for the --antialiased trial")
    p.add_argument("--depth-reg", action="store_true",
                   help="enable --regularize-depth with GT depth rendered "
                        "from the GT scene (sparse-depth loss path)")
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def eval_boundaries(step: int, iters: int, eval_every: int, reset_every: int,
                    densify_end: int, mcmc: bool):
    """The next eval boundary after ``step`` and whether it was deferred
    past an opacity reset (a reset degrades the model for a few hundred
    steps; sampling held-out PSNR right at it misreports training health)."""
    boundary = min(step + eval_every, iters)
    post_reset = (reset_every > 0 and not mcmc and boundary % reset_every == 0
                  and boundary <= densify_end)
    if post_reset and boundary < iters:
        boundary = min(boundary + max(300, eval_every // 2), iters)
    return boundary, post_reset


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("quality")
    dev = resolve_device(args.device)

    H, W = args.height, args.width
    rng = np.random.default_rng(args.seed)

    # --- ground-truth scene + images -------------------------------------
    means, log_scales, quats, colors, opac = make_gt_scene(seed=args.seed)
    n_gt = len(means)
    gt_state = make_gt_state(means, log_scales, quats, colors, opac, 3, dev)
    cams = orbit_cameras(args.cameras, width=W, height=H, radius=3.2, fov=0.9)
    render_gt = gt_renderer(gt_state, 3, args.gt_rasterizer, dup_capacity=GT_DUP_CAPACITY,
                            max_per_tile=args.gt_max_per_tile,
                            span_capacity=GT_SPAN_CAPACITY)

    log.info("rendering %d GT views of %d-splat scene at %dx%d", len(cams), n_gt, W, H)
    gt_dev = {}
    for i, cam in enumerate(cams):
        img, depth, dropped = render_gt(cam.params(dev), H, W)
        assert dropped == 0, (f"GT view {i}: {dropped} intersections dropped: raise the GT "
                              "render budgets")
        gt_dev[cam.name] = img  # stays on the device for the trainer's image cache
        cam._image = img.cpu().numpy()
        if args.depth_reg:
            # GT-scene depth stands in for a monocular estimate.
            cam.estimated_depth = depth.cpu().numpy()
        if i == 0:
            log.info("GT view 0 coverage %.2f", float((cam._image.sum(-1) > 0.02).mean()))

    train_cams = [c for i, c in enumerate(cams) if i % args.holdout != 0]
    eval_cams = [c for i, c in enumerate(cams) if i % args.holdout == 0]

    # --- trainee: a uniform random cloud in the scene's box (no GT-derived
    # positions or colours; densification must find the geometry) ---------
    lo, hi = means.min(axis=0), means.max(axis=0)
    init_xyz = rng.uniform(lo, hi, size=(args.init_points, 3))
    init_rgb = rng.uniform(0.2, 0.8, size=(args.init_points, 3))
    state = init_from_pcd(init_xyz.astype(np.float32), init_rgb * 255.0, sh_degree=3,
                          capacity=args.capacity, device=dev)

    cfg = Config(rasterizer="auto", sh_degree=3, max_iter=args.iters,
                 eval_interval=0, densify_end=args.iters * 10 // 15,
                 densify_strategy=args.densify_strategy,
                 antialiased=args.antialiased,
                 regularize_depth=args.depth_reg)
    trainer = Trainer(cfg, Scene(train_cams), state)
    trainer.eval_cameras = eval_cams
    # The GT frames are already on the device: no second upload.
    for cam in train_cams:
        trainer._image_cache[(cam.name, W, H)] = gt_dev[cam.name]

    # Eval on a fixed cadence by hand, so that time-to-target is measured on
    # the training clock.
    t0 = time.perf_counter()
    eval_history = []
    time_to_target = None
    while trainer.step < args.iters:
        boundary, post_reset = eval_boundaries(
            trainer.step, args.iters, args.eval_every, cfg.interval_opacity_reset,
            cfg.densify_end, args.densify_strategy == "mcmc")
        trainer.run(boundary)
        ev_i = trainer.evaluate()
        wall = time.perf_counter() - t0
        entry = {"step": trainer.step, "minutes": round(wall / 60, 2),
                 "psnr": round(ev_i["eval_psnr"], 2)}
        if post_reset:
            entry["post_opacity_reset"] = True
        eval_history.append(entry)
        if time_to_target is None and ev_i["eval_psnr"] >= args.target_psnr:
            time_to_target = wall
            log.info("reached %.1f dB at step %d (%.1f min)", args.target_psnr, trainer.step,
                     wall / 60)
    dt = time.perf_counter() - t0

    save_checkpoint(os.path.join(tempfile.gettempdir(), "quality_model.npz"), trainer.state,
                    None, step=trainer.step)

    # Diagnostic: a TRAIN camera through the eval path separates render-path
    # bugs from generalization gaps.
    tc = train_cams[0]
    rgb_tc, _ = trainer.render_camera(tc)
    gt_tc = torch.as_tensor(tc.get_original_image((tc.width, tc.height)), device=dev)
    log.info("train-cam inference-path PSNR: %.2f", float(psnr(rgb_tc, gt_tc)))

    ev = trainer.evaluate()

    # Multi-scale held-out eval: GT re-rendered from the GT scene at each
    # scale (a true multi-scale reference, not a resampled image).
    scales = [float(s) for s in args.eval_scales.split(",") if s.strip()]
    multiscale = {}
    for s in scales:
        h2 = max(int(round(H * s)) // 16 * 16, 16)
        w2 = max(int(round(W * s)) // 16 * 16, 16)
        st = trainer.state
        vals = []
        for cam in eval_cams:
            cp = Trainer._scale_cam_params(cam.params(dev), cam, h2, w2)
            gt2, _, _ = render_gt(cp, h2, w2)
            with torch.no_grad():
                rgb2, _ = render(st.params, st.alive, cp, h2, w2, st.active_sh_degree,
                                 torch.zeros(3, device=dev), rasterizer=cfg.rasterizer,
                                 dup_capacity=cfg.dup_capacity, max_per_tile=cfg.max_per_tile,
                                 span_capacity=cfg.span_capacity,
                                 antialiased=cfg.antialiased)
            vals.append(float(psnr(rgb2, gt2)))
        multiscale[f"{s:g}x"] = round(float(np.mean(vals)), 2)
    if multiscale:
        log.info("multi-scale held-out PSNR: %s", multiscale)

    out = {
        "metric": "heldout_psnr_7k",
        "value": round(ev["eval_psnr"], 2),
        "unit": "dB",
        "eval_ssim": round(ev["eval_ssim"], 4),
        "gt_rasterizer": args.gt_rasterizer,
        "init": "uniform_random_aabb",
        "densify_strategy": args.densify_strategy,
        "antialiased": args.antialiased,
        "depth_reg": args.depth_reg,
        **({"multiscale_psnr": multiscale} if multiscale else {}),
        "minutes_to_%gdB" % args.target_psnr: (
            round(time_to_target / 60, 1) if time_to_target else None),
        "eval_history": eval_history,
        "iters": args.iters,
        "steps_per_s": round(args.iters / dt, 2),
        "train_minutes": round(dt / 60, 1),
        "num_splats": int(trainer.state.num_live()),
        "capacity": int(trainer.state.capacity),
        "resolution": [H, W],
        "train_cameras": len(train_cams),
        "eval_cameras": len(eval_cams),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
