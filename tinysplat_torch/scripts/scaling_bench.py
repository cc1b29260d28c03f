"""The sharded trainer's scaling structure: band imbalance and total work.

    python -m tinysplat_torch.scripts.scaling_bench [--devices 8] [--out F.json]
    python -m tinysplat_torch.scripts.scaling_bench --device cpu --devices 4 \
        --width 64 --height 64

Port of the JAX package's ``scripts/scaling_bench.py``, with its flags,
defaults and JSON keys. It puts numbers on the two costs of a (data x tile)
mesh that the collective volume does not show:

1. The per-band intersection spread: the quality bench's GT scene at 40 x
   400 (58,000 splats, SH 1; clustered shells, a slab and a dome, the
   distribution of a trained scene) is projected from ``--cameras`` orbit
   views and binned band by band as the sharded step bins it, in contiguous
   strips (the centers shifted by b Hl) and interleaved 16-px tile rows
   (``row_stride`` 4, ``row_offset`` b). The mean over cameras of the worst
   band over the mean band is the band imbalance factor: the worst band
   paces every step of a real mesh. The counts are integers, the JAX
   script's on the same scene.
2. The total work of the sharded step: ``make_sharded_train_step`` on the
   scene's first 16,384 points (SH 1) over a (devices / 4, 4) mesh of
   ``--devices`` local ranks (``parallel.local.run``), one camera per data
   group, against the same step on a (1, 1) mesh of a one-rank world with
   one camera, times the batch. Each step is timed over 3 iterations after
   a warm-up step, the device synchronized at the end; a mesh step is its
   slowest rank's. The ranks share one card (or the CPU under ``--device
   cpu``), so they run gloo (NCCL refuses two ranks on one card) and
   timeshare it: a speed-up means nothing, and the total-work ratio isolates
   the binning each band repeats and the band imbalance (1.0 = none), not
   the links between cards.

Writes ``--out`` (default ``SCALING_torch_structure.json``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.synthetic import orbit_cameras
from ..models.gaussians import GaussianState, init_from_pcd
from ..ops.binning import bin_splats_dense
from ..ops.projection import project_gaussians
from ..parallel import local
from ..utils.device import resolve_device
from .quality_bench import make_gt_scene, make_gt_state

N_TILE = 4  # the mesh's 'tile' axis
STEP_POINTS = 1 << 14  # splats of the timed step
STEP_ITERS = 3


def band_counts(state: GaussianState, cam, height: int, width: int, n_tile: int = N_TILE):
    """Intersections of each of ``n_tile`` bands of one camera's frame:
    (contiguous strips, interleaved 16-px tile rows), lists of ints."""
    H, W, n = height, width, state.capacity
    Hl = H // n_tile
    p = state.params
    proj = project_gaussians(
        means=p.means, scales=torch.exp(p.scales), glob_scale=1.0, quats=p.quats,
        viewmat=cam.viewmat, full_projmat=cam.projmat @ cam.viewmat, fx=cam.fx, fy=cam.fy,
        cx=W / 2.0, cy=H / 2.0, img_height=H, img_width=W, tile_size=16)
    opacs = torch.sigmoid(p.opacities.reshape(-1))
    valid = proj.valid & state.alive
    contig, inter = [], []
    for b in range(n_tile):
        # Contiguous band b: rows [b Hl, (b + 1) Hl), band-local coordinates.
        shift = proj.xys.new_tensor([0.0, b * Hl])
        bins = bin_splats_dense(proj.xys - shift, proj.depths, proj.radii, valid, W // 16,
                                Hl // 16, 16, dup_capacity=16 * n, conics=proj.conics,
                                opacities=opacs)
        contig.append(int(bins.total_intersections))
        # Interleaved band b (cfg.band_interleave): global tile rows {b, b + n_tile, ...}.
        bins = bin_splats_dense(proj.xys, proj.depths, proj.radii, valid, W // 16, Hl // 16,
                                16, dup_capacity=16 * n, conics=proj.conics, opacities=opacs,
                                row_stride=n_tile, row_offset=b)
        inter.append(int(bins.total_intersections))
    return contig, inter


def spread(per_band):
    """(mean band, mean over cameras of the worst band, their ratio) of
    (cameras, bands) counts."""
    per_band = np.asarray(per_band, np.float64)
    mean = float(per_band.mean())
    mx = float(per_band.max(axis=1).mean())
    return mean, mx, mx / max(mean, 1.0)


def sharded_step_ms(mesh_shape, batch: int, height: int, width: int, means, colors, cams,
                    capacity: int, device: str) -> dict:
    """One rank of part 2 (run by ``parallel.local.run``): the sharded step
    of ``mesh_shape`` on ``means`` in ``capacity`` slots, its ms a step
    over ``STEP_ITERS`` after a warm-up, and the kernels' launches in all
    of them."""
    from ..ops import _build
    from ..parallel import make_mesh, make_sharded_train_step, rank_device, shard_state
    from ..parallel.train_step import band_rows
    from ..train import init_opt_state
    from ..utils.device import synchronize

    dev = rank_device(device)
    mesh = make_mesh(*mesh_shape)
    cfg = Config(sh_degree=1)
    full = init_from_pcd(means, colors * 255.0, sh_degree=1, capacity=capacity, device=dev)
    state, _ = shard_state(mesh, full)
    opt = init_opt_state(cfg, state)
    d_idx, t_idx = mesh.coords
    bl = batch // mesh.data
    local_cams = [c.params(dev) for c in cams[d_idx * bl:(d_idx + 1) * bl]]
    gt = np.random.default_rng(0).uniform(0, 1, (batch, height, width, 3)).astype(np.float32)
    rows = band_rows(height, mesh.tile, t_idx, cfg.tile_size,
                     cfg.band_interleave and mesh.tile > 1).numpy()
    gt = torch.as_tensor(gt[d_idx * bl:(d_idx + 1) * bl][:, rows], device=dev)
    fn = make_sharded_train_step(cfg, height, width, batch, mesh)
    generator = torch.Generator(device=dev)
    kernels = ("composite_fwd", "composite_bwd", "segsum", "splat_fwd", "splat_bwd", "bin_count",
               "bin_emit", "radix_hist", "radix_scatter", "ssim_fwd", "ssim_bwd", "scatter_rows")

    def step(s):
        generator.manual_seed(0)
        return fn(s, opt, local_cams, gt, None, 0, generator=generator).state

    state = step(state)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(STEP_ITERS):
        state = step(state)
    synchronize(dev)
    ms = (time.perf_counter() - t0) / STEP_ITERS * 1e3
    return {"rank": mesh.rank, "ms": ms,
            "launches": {k: _build.launches[k] for k in kernels}}


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Band imbalance and sharded-step total work")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--cameras", type=int, default=4)
    p.add_argument("--out", default="SCALING_torch_structure.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None, history: Optional[dict] = None) -> dict:
    """Returns the JSON line's dict. ``history``, when given, receives the
    per-camera ``band_counts`` and each world's ``ranks`` (ms, launches)."""
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    H, W = args.height, args.width
    n_data = args.devices // N_TILE

    # -- 1. per-band intersection spread at realistic scale
    means, log_scales, quats, colors, opac = make_gt_scene(n_clusters=40, per_cluster=400,
                                                           seed=0)
    n = len(means)
    state = make_gt_state(means, log_scales, quats, colors, opac, 1, dev)
    cams = orbit_cameras(args.cameras, width=W, height=H, radius=3.2, fov=0.9)
    with torch.no_grad():
        both = [band_counts(state, c.params(dev), H, W) for c in cams]
    del state
    band_mean, band_max, imbalance = spread([c for c, _ in both])
    _, band_max_i, imbalance_i = spread([i for _, i in both])

    # -- 2. sharded-step total-work overhead
    pts, cols = means[:STEP_POINTS], colors[:STEP_POINTS]
    B = n_data
    # The ranks unpickle the function by its module's name, which is
    # __main__ under ``python -m``: take it from the package's module.
    from .scaling_bench import sharded_step_ms

    ranks_n = local.run(sharded_step_ms, args.devices,
                        args=((n_data, N_TILE), B, H, W, pts, cols, cams, STEP_POINTS,
                              dev.type), device=dev.type)
    ranks_1 = local.run(sharded_step_ms, 1, args=((1, 1), 1, H, W, pts, cols, cams,
                                                  STEP_POINTS, dev.type), device=dev.type)
    t_n = max(r["ms"] for r in ranks_n) / 1e3
    t_1 = ranks_1[0]["ms"] / 1e3
    overhead = t_n / max(t_1 * B, 1e-9)
    if history is not None:
        history.update(band_counts=both, ranks=ranks_n, ranks_1=ranks_1)

    out = {
        "metric": "scaling_structure",
        "devices": args.devices,
        "mesh": [n_data, N_TILE],
        "resolution": [H, W],
        "scene_splats": n,
        "band_intersections_mean": round(band_mean),
        "band_intersections_max_over_cams": round(band_max),
        "band_imbalance_factor": round(imbalance, 2),
        "band_intersections_max_interleaved": round(band_max_i),
        "band_imbalance_factor_interleaved": round(imbalance_i, 2),
        "note_imbalance": "max-band/mean-band intersections; the worst band "
                          "bounds real-slice step time at this mesh shape. "
                          "_interleaved = cfg.band_interleave (default on): "
                          "16px tile rows round-robined over bands",
        "step_ms_1dev_x_batch": round(t_1 * B * 1e3, 1),
        "step_ms_sharded": round(t_n * 1e3, 1),
        "sharded_work_overhead": round(overhead, 2),
        "note_overhead": f"{args.devices} local ranks are processes that timeshare one "
                         f"{'card' if dev.type == 'cuda' else 'CPU'} over gloo; the (1, 1) "
                         "side is a one-rank world; total-work ratio isolates replicated "
                         "binning + imbalance (1.0 = none), not links between cards",
    }
    print(json.dumps(out), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
