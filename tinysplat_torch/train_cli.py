"""Training CLI of the port, with the flags of the JAX package's trainer.

    python -m tinysplat_torch.train_cli --train --no-viewer --synthetic \
        --max-iter 200 [--device cuda] [--save-checkpoints ...]

Flags are generated from ``Config``, with the names and defaults of
``scripts/train.py``; ``--device`` defaults to ``cuda`` here. The
``--synthetic`` scene (10 orbit views of a 400-splat random cloud, rendered
by the port's own renderer) trains without any dataset. Resume with
``--load-checkpoint ckpt.npz`` (a checkpoint of either package; the
``pose_opt`` / ``app_opt`` tables come back from its extras), hold out
every k-th camera for evaluation with ``--eval-holdout k``.

Not ported yet (raise NotImplementedError): COLMAP and Blender datasets and
``--viewer`` (slice D; pass ``--no-viewer``), and the distributed / mesh
flags (ROADMAP Queue 1 item 16).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Optional, Sequence

from .config import Config
from .train import _not_ported

_TYPES = {"int": int, "float": float, "str": str, "Optional[str]": str,
          "Optional[int]": int}


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tinysplat PyTorch trainer")
    for f in dataclasses.fields(Config):
        flag = "--" + f.name.replace("_", "-")
        default = "cuda" if f.name == "device" else f.default
        if f.type in ("bool", bool):
            parser.add_argument(flag, default=default, action=argparse.BooleanOptionalAction)
        else:
            parser.add_argument(flag, type=_TYPES.get(str(f.type), str), default=default)
    return parser


def check_flags(cfg: Config) -> None:
    """Raise for the flags whose modules a later slice brings."""
    if cfg.viewer:
        raise _not_ported("--viewer (pass --no-viewer)", "viewer.py", "slice D")
    if (cfg.distributed or cfg.coordinator_address or cfg.mesh_tile > 1
            or cfg.mesh_splat > 1):
        raise _not_ported("multi-device training (--distributed, --mesh-tile, --mesh-splat)",
                          "parallel/ on torch.distributed", "item 16")
    if not cfg.synthetic:
        raise _not_ported("training on a dataset (use --synthetic)",
                          "data/colmap.py, data/dataset.py and data/blender.py", "slice D")


def build_scene(cfg: Config, device):
    """The synthetic scene: (scene, pcd). Ground truth comes from a fixed
    random splat cloud rendered with the port's renderer."""
    import numpy as np
    import torch

    from .data.synthetic import orbit_cameras, random_gaussian_cloud, synthetic_pcd
    from .models.gaussians import init_from_pcd
    from .render import render
    from .scene import Scene

    cams = orbit_cameras(10, width=128, height=128)
    means, log_scales, quats, colors, opac = random_gaussian_cloud(400, seed=7)
    gt = init_from_pcd(means, colors * 255, sh_degree=1, capacity=512, device=device)
    with torch.no_grad():
        gt.params.scales[:400] = torch.as_tensor(log_scales).to(device)
        gt.params.opacities[:400] = torch.as_tensor(opac).to(device)
        for cam in cams:
            rgb, _ = render(gt.params, gt.alive, cam.params(device), 128, 128, 1,
                            torch.zeros(3, device=device), rasterizer=cfg.rasterizer)
            cam._image = np.asarray(rgb.cpu())
    return Scene(cams, seed=cfg.seed), synthetic_pcd(500, seed=1)


def main(argv: Optional[Sequence[str]] = None):
    """Parse the flags, build the scene and state, train; returns the
    trainer."""
    logging.basicConfig(level=getattr(logging, os.environ.get("LOG_LEVEL", "INFO")),
                        format="%(asctime)s - %(levelname)s - %(message)s")
    cfg = Config(**vars(arg_parser().parse_args(argv)))
    check_flags(cfg)
    cfg = dataclasses.replace(
        cfg,
        colmap_path=os.path.join(cfg.dataset_dir, cfg.colmap_path),
        images_path=os.path.join(cfg.dataset_dir, cfg.images_path),
        depths_path=os.path.join(cfg.dataset_dir, cfg.depths_path),
    )

    from .io.checkpoint import load_checkpoint, load_checkpoint_extras
    from .models.gaussians import init_from_pcd
    from .train_loop import Trainer
    from .utils.device import resolve_device

    device = resolve_device(cfg.device)
    scene, pcd = build_scene(cfg, device)
    eval_cameras = []
    if cfg.eval_holdout > 1:  # every k-th camera held out for evaluation
        all_cams = scene.cameras
        eval_cameras = all_cams[::cfg.eval_holdout]
        scene.cameras = [c for i, c in enumerate(all_cams) if i % cfg.eval_holdout != 0]

    opt_state, start_step, rng_state = None, 0, None
    if cfg.load_checkpoint:
        state, opt_state, start_step, rng_state = load_checkpoint(cfg.load_checkpoint, cfg,
                                                                  device)
    else:
        state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=cfg.sh_degree,
                              capacity=cfg.capacity, seed=cfg.seed, device=device)
    trainer = Trainer(cfg, scene, state, opt_state, start_step, rng_state)
    if cfg.load_checkpoint and (cfg.pose_opt or cfg.app_opt):
        trainer.restore_pose_state(load_checkpoint_extras(cfg.load_checkpoint))
    trainer.eval_cameras = eval_cameras
    scene.render_fn = lambda camera, dims=None: trainer.render_camera(camera, dims)
    if cfg.train:
        trainer.run()
    return trainer


if __name__ == "__main__":
    main()
