"""Render a camera path from a checkpoint to image frames (turntable CLI).

Serves frames of a trained scene on the GPU from a ``.npz`` checkpoint —
one written by either package's ``save_checkpoint`` — along an orbit
around the model.

Usage:
    python -m tinysplat_torch.render_path ckpt.npz outdir/ --frames 120 \
        --width 800 --height 600 [--radius 3.2] [--device cuda]

Writes outdir/frame_0000.png ... ; assemble with ffmpeg if desired.
"""
from __future__ import annotations

import argparse
import os


def _save_frame(rgb, path: str) -> None:
    import numpy as np
    from PIL import Image

    arr = (np.clip(rgb.detach().cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint")
    p.add_argument("outdir")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--radius", type=float, default=3.0)
    p.add_argument("--fov", type=float, default=0.9)
    p.add_argument("--rasterizer", default="auto")
    p.add_argument("--sh-degree", type=int, default=-1,
                   help="-1 = the checkpoint's full degree")
    p.add_argument("--background", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from .data.synthetic import orbit_cameras
    from .io.checkpoint import load_model
    from .render import render

    state = load_model(args.checkpoint, device=args.device)
    deg = state.active_sh_degree if args.sh_degree < 0 else args.sh_degree
    H, W = args.height, args.width
    bg = torch.tensor(args.background, dtype=torch.float32, device=state.alive.device)

    cams = orbit_cameras(args.frames, width=W, height=H, radius=args.radius,
                         fov=args.fov)
    os.makedirs(args.outdir, exist_ok=True)
    with torch.no_grad():
        for i, cam in enumerate(cams):
            rgb, _ = render(state.params, state.alive, cam.params(args.device), H, W,
                            deg, bg, rasterizer=args.rasterizer)
            _save_frame(rgb, os.path.join(args.outdir, f"frame_{i:04d}.png"))
            if (i + 1) % 10 == 0 or i == len(cams) - 1:
                print(f"rendered {i + 1}/{len(cams)}", flush=True)


if __name__ == "__main__":
    main()
