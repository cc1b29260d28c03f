"""Training CLI of the port, with the flags of the JAX package's trainer.

    python -m tinysplat_torch.train_cli --train --dataset-dir datasets/truck \
        [--regularize-depth --depth-model sparse_interp] [--viewer] \
        [--device cuda] [--save-checkpoints ...]

Flags are generated from ``Config``, with the names and defaults of
``scripts/train.py``; ``--device`` defaults to ``cuda`` here. The scene is
a COLMAP capture (``<dataset-dir>/<colmap-path>`` with images under
``<dataset-dir>/<images-path>``) when that directory exists or no
``transforms*.json`` does, else a Blender / nerfstudio ``transforms.json``
scene (trained over white unless ``--background black``); ``--synthetic``
(10 orbit views of a 400-splat random cloud, rendered by the port's own
renderer) needs no dataset. ``--regularize-depth`` estimates and caches a
depth map per training camera under ``<dataset-dir>/<depths-path>`` first.
``--viewer`` serves the live websocket viewer on
``--viewer-ip``/``--viewer-port`` while training runs in a worker thread
(``Trainer.run_async``); it keeps serving after the last step. Resume with
``--load-checkpoint ckpt.npz`` (a checkpoint of either package; the
``pose_opt`` / ``app_opt`` tables come back from its extras), hold out
every k-th camera for evaluation with ``--eval-holdout k``.

Multi-device training: one process per rank, each with the same flags.
``--mesh-splat D --mesh-tile T`` shape the ('data', 'tile') mesh of D * T
ranks (``parallel.MeshTrainer``). The ranks join through
``--coordinator-address host:port --num-processes N --process-id r``
(``init_process_group`` with ``tcp://host:port``), or, with ``--distributed``
alone, the ``torchrun`` environment:

    torchrun --nproc-per-node 4 -m tinysplat_torch.train_cli --distributed \
        --mesh-splat 2 --mesh-tile 2 --train --synthetic --no-viewer

A sharded checkpoint is a directory (``<timestamp>-<step>.ckpt``), which
``--load-checkpoint`` reads as well as a ``.npz``. ``--viewer`` is off when
there are several ranks: a frame is a collective render over every rank,
which a viewer on one rank cannot drive.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import os
from typing import Optional, Sequence

from .config import Config

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


def check_flags(cfg: Config, world_size: int = 1) -> None:
    """Raise when the mesh of ``--mesh-splat`` / ``--mesh-tile`` does not
    cover the ``world_size`` ranks exactly: ``--mesh-splat`` data groups,
    and ``--mesh-tile`` ranks on the tile axis, or every rank left over
    when it is 0 or 1 (the default)."""
    data = max(cfg.mesh_splat, 1)
    tile = cfg.mesh_tile if cfg.mesh_tile > 1 else max(world_size // data, 1)
    if data * tile != world_size:
        raise ValueError(
            f"--mesh-splat {cfg.mesh_splat} --mesh-tile {cfg.mesh_tile} needs "
            f"{data * tile} ranks, there are {world_size}: start one process per "
            "rank (--distributed under torchrun, or --coordinator-address, "
            "--num-processes and --process-id)")


def init_world(cfg: Config) -> int:
    """Join the process group the flags name (or the one already there);
    returns the world size."""
    import torch.distributed as dist

    from .parallel import init_distributed

    if cfg.coordinator_address:
        init_distributed(f"tcp://{cfg.coordinator_address}", rank=max(cfg.process_id, 0),
                         world_size=max(cfg.num_processes, 1), device=cfg.device)
    elif cfg.distributed:
        init_distributed(device=cfg.device)  # the torchrun environment
    return dist.get_world_size() if dist.is_initialized() else 1


def build_scene(cfg: Config, device):
    """Dataset -> (scene, pcd, cfg). The returned cfg may carry a
    dataset-driven default: a fixed white background for transforms.json
    scenes. ``device`` is where the synthetic scene's ground truth renders."""
    from .scene import Scene

    if cfg.synthetic:
        return _synthetic_scene(cfg, device) + (cfg,)
    # COLMAP first when a sparse reconstruction exists (nerfstudio exports
    # often ship both transforms.json and colmap/, and SfM points beat a
    # random init cloud); otherwise a transforms*.json scene.
    tj = None
    for cand in ("transforms_train.json", "transforms.json"):
        p = os.path.join(cfg.dataset_dir, cand)
        if os.path.exists(p):
            tj = p
            break
    if os.path.isdir(cfg.colmap_path) or tj is None:
        from .data.dataset import Dataset

        dataset = Dataset(cfg.colmap_path, cfg.images_path,
                          max_image_dimension=cfg.max_image_dimension or None)
    else:
        from .data.blender import BlenderDataset

        if cfg.background == "random":
            # RGBA GT frames are composited onto a fixed colour at load; a
            # per-step random training background would force the model to
            # build an opaque backdrop shell. White is the NeRF-synthetic
            # convention; --background black overrides.
            logging.getLogger(__name__).info(
                "transforms.json scene: training background set to 'white' "
                "to match GT compositing (--background overrides)")
            cfg = dataclasses.replace(cfg, background="white")
        bg = (0.0, 0.0, 0.0) if cfg.background == "black" else (1.0, 1.0, 1.0)
        dataset = BlenderDataset(
            tj, seed=cfg.seed, num_init_points=cfg.random_init_points, background=bg,
            max_image_dimension=cfg.max_image_dimension or None)
    return Scene(dataset.cameras, seed=cfg.seed), dataset.pcd, cfg


def _synthetic_scene(cfg: Config, device):
    """(scene, pcd) of ``--synthetic``: ground truth from a fixed random
    splat cloud rendered with the port's renderer."""
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
    """Parse the flags, build the scene and state, train (beside the live
    viewer with ``--viewer``); returns the trainer."""
    logging.basicConfig(level=getattr(logging, os.environ.get("LOG_LEVEL", "INFO")),
                        format="%(asctime)s - %(levelname)s - %(message)s")
    cfg = Config(**vars(arg_parser().parse_args(argv)))
    world = init_world(cfg)
    check_flags(cfg, world)
    cfg = dataclasses.replace(
        cfg,
        colmap_path=os.path.join(cfg.dataset_dir, cfg.colmap_path),
        images_path=os.path.join(cfg.dataset_dir, cfg.images_path),
        depths_path=os.path.join(cfg.dataset_dir, cfg.depths_path),
    )

    from .io.checkpoint import (
        load_checkpoint,
        load_checkpoint_extras,
        load_checkpoint_sharded_extras,
        restore_checkpoint_sharded,
    )
    from .models.gaussians import init_from_pcd
    from .parallel import MeshTrainer, rank_device
    from .train_loop import Trainer
    from .utils.device import resolve_device

    device = rank_device(cfg.device) if world > 1 else resolve_device(cfg.device)
    scene, pcd, cfg = build_scene(cfg, device)
    eval_cameras = []
    if cfg.eval_holdout > 1:  # every k-th camera held out for evaluation
        all_cams = scene.cameras
        eval_cameras = all_cams[::cfg.eval_holdout]
        scene.cameras = [c for i, c in enumerate(all_cams) if i % cfg.eval_holdout != 0]

    opt_state, start_step, rng_state = None, 0, None
    sharded_ckpt = bool(cfg.load_checkpoint) and os.path.isdir(cfg.load_checkpoint)
    if sharded_ckpt:  # the whole state on every rank; the trainer shards it
        state, opt_state, start_step, rng_state = restore_checkpoint_sharded(
            cfg.load_checkpoint, cfg, device=device)
    elif cfg.load_checkpoint:
        state, opt_state, start_step, rng_state = load_checkpoint(cfg.load_checkpoint, cfg,
                                                                  device)
    else:
        state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=cfg.sh_degree,
                              capacity=cfg.capacity, seed=cfg.seed, device=device)
    if cfg.regularize_depth and not cfg.synthetic:
        from .depthest import DepthEstimator

        DepthEstimator(scene, pcd=pcd, depths_path=cfg.depths_path, model_name=cfg.depth_model)
    if world > 1 or cfg.mesh_splat > 1 or cfg.mesh_tile > 1:
        trainer = MeshTrainer(cfg, scene, state, opt_state, start_step, rng_state)
    else:
        trainer = Trainer(cfg, scene, state, opt_state, start_step, rng_state)
    if cfg.load_checkpoint and (cfg.pose_opt or cfg.app_opt):
        extras = (load_checkpoint_sharded_extras if sharded_ckpt else
                  load_checkpoint_extras)(cfg.load_checkpoint)
        trainer.restore_pose_state(extras)
    trainer.eval_cameras = eval_cameras
    scene.render_fn = lambda camera, dims=None: trainer.render_camera(camera, dims)
    if cfg.viewer and world > 1:
        logging.getLogger(__name__).warning(
            "--viewer is off with %d ranks: a frame is a render over every rank, which a "
            "viewer on one rank cannot drive (use --eval-interval, or render a checkpoint)",
            world)
        cfg = dataclasses.replace(cfg, viewer=False)
    if cfg.viewer:
        from .viewer import Viewer

        async def serve_and_train():
            coroutines = [Viewer(scene, cfg.viewer_ip, cfg.viewer_port).run()]
            if cfg.train:
                coroutines.append(trainer.run_async())
            await asyncio.gather(*coroutines)

        asyncio.run(serve_and_train())
    elif cfg.train:
        trainer.run()
    return trainer


if __name__ == "__main__":
    main()
