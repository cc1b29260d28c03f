"""Multi-device rays/s efficiency model, every per-device term measured on
one card.

    python -m tinysplat_torch.scripts.scaling_model [--iters 20] [--out F.json]
    python -m tinysplat_torch.scripts.scaling_model --device cpu --height 64 \
        --width 96 --clusters 4 --per-cluster 60 --iters 2

Port of the JAX package's ``scripts/scaling_model.py``, with its flags,
defaults and JSON keys. One card cannot run a multi-card mesh, so this
measures the exact per-device work a (data x tile) mesh schedules and
models the rest:

  t_plain          the one-device train step (``make_train_step``): the
                   denominator;
  t_machinery      the sharded step (``make_sharded_train_step``) on a real
                   (1, 1) mesh of a one-rank world (NCCL on the card, gloo
                   on the CPU) less t_plain: the collectives' plumbing and
                   the band path, charged unscaled to every device;
  t_grad_band(t,o) the render gradient of one device's interleaved band
                   (``row_stride`` t, ``row_offset`` o) of the clustered
                   scene, for every offset o: the max over o is the band
                   imbalance, measured; each band's budgets are first
                   probed to drop no entry;
  t_overhead(t)    everything but the render gradient at band scale: the
                   sharded step at image height H / t less its own band
                   gradient (the losses, SSIM and Adam at band size; Adam
                   over all the parameters, where a mesh shards it 1 / (d t):
                   pessimistic).

``predict`` turns them into the step time of a (d, t) mesh with B = d
cameras, T(d, t) = max_o t_grad_band(t, o) + t_overhead(t) + t_coll(d, t),
where t_coll moves the FSDP parameter gather over 'data' and the projected
attributes over 'tile' and their reduce-scatters, not overlapped with
compute, at ``--ici-gbps`` (default 900 GB/s, the bidirectional NVLink 4
bandwidth of one H100 SXM, from its data sheet; the flag keeps the JAX
script's name). rays/s = d H W / T; efficiency vs one device = t_plain /
(t T). With one card the link is never measured: NCCL between cards is
not exercised, so t_coll and everything that depends on it are a model.

Writes ``--out`` (default ``SCALING_torch_model.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..config import Config
from ..data.synthetic import orbit_cameras
from ..render import render
from ..train import init_opt_state, make_train_step
from ..utils.device import resolve_device, synchronize
from .profile_bench import render_grad
from .quality_bench import make_gt_scene, make_gt_state

BANDS = (1, 2, 4, 8, 16)
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (1, 8), (2, 4), (4, 2), (2, 8), (4, 4), (8, 2)]
NVLINK_GBPS = 900.0
NVLINK_SOURCE = "NVLink 4, bidirectional per GPU (NVIDIA H100 SXM data sheet)"


def predict(t_plain: float, t_grad_band: Dict[int, List[float]], t_overhead: Dict[int, float],
            n: int, sh_degree: int, link_gbps: float, height: int = 1024,
            width: int = 1600):
    """(predicted, value): per mesh "dxt" with a measured band count t, its
    ``chips``, ``t_step_ms``, ``t_coll_ms``, ``rays_per_s`` and
    ``efficiency_vs_1chip`` (the JAX script's rounding), and the best
    8-device mesh's efficiency."""
    sh_dim = 3 * (sh_degree + 1) ** 2
    param_bytes = n * (11 + sh_dim) * 4
    proj_bytes = n * 12 * 4

    def t_coll(d, t):
        fsdp = 2 * param_bytes * (d - 1) / max(d, 1)
        proj = 2 * proj_bytes * (t - 1) / max(t, 1)
        return (fsdp + proj) / (link_gbps * 1e9) * 1e3

    pred = {}
    for d, t in MESHES:
        if t not in t_grad_band:
            continue
        T = max(t_grad_band[t]) + t_overhead[t] + t_coll(d, t)
        eff = t_plain / (t * T)
        pred[f"{d}x{t}"] = {
            "chips": d * t,
            "t_step_ms": round(T, 2),
            "t_coll_ms": round(t_coll(d, t), 4),
            "rays_per_s": round(d * height * width / T * 1e3, 0),
            "efficiency_vs_1chip": round(eff, 3),
        }
    best8 = max((v for v in pred.values() if v["chips"] == 8),
                key=lambda v: v["efficiency_vs_1chip"])
    return pred, best8["efficiency_vs_1chip"]


def _time(fn, iters: int, device, warmup: int = 2) -> float:
    """ms a call of ``fn`` over ``iters`` after ``warmup``, the device
    synchronized at both ends."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def _time_step(step, state, iters: int, device) -> float:
    """ms a step of ``step(state) -> state`` over ``iters`` after one."""
    state = step(state)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multi-device efficiency model from one card")
    p.add_argument("--height", type=int, default=1024)  # 64 tile rows: all t
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--ici-gbps", type=float, default=NVLINK_GBPS,
                   help="link bandwidth between devices, GB/s bidirectional per device "
                        f"(default {NVLINK_GBPS:g}: {NVLINK_SOURCE})")
    p.add_argument("--clusters", type=int, default=70)
    p.add_argument("--per-cluster", type=int, default=2500)
    p.add_argument("--out", default="SCALING_torch_model.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None, history: Optional[dict] = None) -> dict:
    """Returns the dict written to ``--out``. ``history``, when given,
    receives the entries each band's probe dropped (``drops``: {t: [per
    offset]})."""
    import torch.distributed as dist

    from ..parallel import init_distributed, make_mesh, make_sharded_train_step, shard_state

    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    H, W = args.height, args.width

    # Realistic clustered scene (dense shells + slab + dome; uniform clouds
    # understate band imbalance).
    scene = make_gt_scene(n_clusters=args.clusters, per_cluster=args.per_cluster, seed=0)
    n = len(scene[0])

    def fresh_state():
        return make_gt_state(*scene, 3, dev)

    state = fresh_state()
    camera = orbit_cameras(1, width=W, height=H, radius=3.2, fov=0.9)[0].params(dev)
    zeros = torch.zeros(3, device=dev)
    generator = torch.Generator(device=dev)

    # The full frame's intersections -> per-band budgets with 2x headroom,
    # each checked to drop nothing below.
    with torch.no_grad():
        _, extras = render(state.params, state.alive, camera, H, W, 3, zeros,
                           dup_capacity=28 * n, span_capacity=10 * n, max_per_tile=16384)
    diag = {k: int(v) for k, v in extras["binning"].items()}
    inter = diag["intersections"]
    assert diag["dup_dropped"] == 0 and diag["tile_dropped"] == 0, diag
    print(f"scene: {n} splats, {inter} intersections at {W}x{H}", flush=True)

    def budgets(t):
        dup = -(-int(inter * 2.0 / t) // 128) * 128
        return dict(dup_capacity=dup, span_capacity=max(dup // 2, 2 * n), max_per_tile=8192)

    def plain_step(cfg, h):
        fn, gt = make_train_step(cfg, h, W), torch.zeros((h, W, 3), device=dev)
        st = fresh_state()
        opt = init_opt_state(cfg, st)

        def step(s):
            generator.manual_seed(0)  # the JAX script's one key at every step
            return fn(s, opt, camera, gt, None, 1, generator=generator).state

        return step, st

    def sharded_step(cfg, h):
        fn = make_sharded_train_step(cfg, h, W, 1, mesh)
        gt = torch.zeros((1, h, W, 3), device=dev)
        st, _ = shard_state(mesh, fresh_state())
        opt = init_opt_state(cfg, st)

        def step(s):
            generator.manual_seed(0)
            return fn(s, opt, [camera], gt, None, 1, generator=generator).state

        return step, st

    own_world = not dist.is_initialized()
    store = tempfile.mkdtemp(prefix="tinysplat_scaling_model_")
    if own_world:
        init_distributed(init_method=f"file://{os.path.join(store, 'store')}", rank=0,
                         world_size=1, device=dev.type)
    try:
        mesh = make_mesh(data=1, tile=1)
        cfg = Config(sh_degree=3, **budgets(1))
        # 1. plain single-device full step (the denominator).
        t_plain = _time_step(*plain_step(cfg, H), args.iters, dev)
        print(f"t_plain = {t_plain:.1f} ms", flush=True)
        # 2. sharded-machinery overhead at a real (1, 1) mesh.
        t_sharded_11 = _time_step(*sharded_step(cfg, H), args.iters, dev)
        t_machinery = max(t_sharded_11 - t_plain, 0.0)
        print(f"t_sharded_1x1 = {t_sharded_11:.1f} ms (machinery +{t_machinery:.1f} ms)",
              flush=True)

        # 3. per-band render gradient, every offset, and 4. the band-height
        # tail = t_step(H / t) - t_grad(H / t).
        t_grad, t_overhead, drops = {}, {}, {}
        for t in BANDS:
            if (H // 16) % t != 0:  # bands must be whole 16px tile rows
                continue
            bud, Hl = budgets(t), H // t
            per_off, dropped = [], []
            for o in range(t):
                band = dict(row_stride=t, row_offset=o, proj_height=H, **bud)
                with torch.no_grad():
                    _, ex = render(state.params, state.alive, camera, Hl, W, 3, zeros, **band)
                dropped.append(int(ex["binning"]["dup_dropped"])
                               + int(ex["binning"]["tile_dropped"]))
                assert dropped[-1] == 0, (t, o, dropped[-1])
                per_off.append(_time(render_grad(state, camera, zeros, Hl, W, **band),
                                     max(args.iters // 2, 8), dev))
            t_grad[t], drops[t] = per_off, dropped
            worst = max(per_off)
            cfg_b = Config(sh_degree=3, **bud)
            t_sharded_b = _time_step(*sharded_step(cfg_b, Hl), args.iters, dev)
            g_plain = _time(render_grad(state, camera, zeros, Hl, W, **bud), args.iters, dev)
            t_overhead[t] = max(t_sharded_b - g_plain, 0.0)
            imb = worst / (sum(per_off) / len(per_off))
            print(f"t={t:2d}: grad worst {worst:.1f} ms (imbalance {imb:.2f}x), sharded band "
                  f"step {t_sharded_b:.1f} ms, plain band grad {g_plain:.1f} ms -> overhead "
                  f"{t_overhead[t]:.1f} ms", flush=True)
    finally:
        if own_world:
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # 5. collectives (not overlapped) over the modelled link.
    pred, value = predict(t_plain, t_grad, t_overhead, n, cfg.sh_degree, args.ici_gbps, H, W)
    for name, v in pred.items():
        print(f"mesh {name} ({v['chips']:2d} chips): T={v['t_step_ms']:6.1f} ms  "
              f"eff={v['efficiency_vs_1chip']:.3f}", flush=True)
    source = NVLINK_SOURCE if args.ici_gbps == NVLINK_GBPS else "given by --ici-gbps"
    if history is not None:
        history.update(drops=drops, probe=diag)
    out = {
        "metric": "predicted_scaling_efficiency",
        "value": value,
        "unit": "rays/s efficiency at 8 chips vs 1 (best mesh)",
        "measured_on_chip": {
            "t_plain_ms": round(t_plain, 2),
            "t_sharded_1x1_ms": round(t_sharded_11, 2),
            "t_machinery_ms": round(t_machinery, 2),
            "t_grad_band_ms": {str(t): [round(x, 2) for x in v] for t, v in t_grad.items()},
            "t_overhead_ms": {str(t): round(v, 2) for t, v in t_overhead.items()},
            "band_imbalance_measured": {str(t): round(max(v) / (sum(v) / len(v)), 3)
                                        for t, v in t_grad.items()},
        },
        "assumptions": [
            "(d x t) mesh, B = d cameras/step (one per data group)",
            f"link {args.ici_gbps} GB/s bidirectional per device ({source}); with one "
            "card the link is modelled, not measured",
            "collectives NOT overlapped with compute (pessimistic)",
            "projection + Adam measured UNSHARDED inside the band grad and"
            " the band-scale sharded step (the real mesh shards both:"
            " pessimistic)",
            "worst band offset paces every step (measured max over o)",
        ],
        "link": {"gbps": args.ici_gbps, "source": source, "measured": False,
                 "note": "one card: NCCL between cards is not exercised, so t_coll and "
                         "the predictions are a model"},
        "predicted": pred,
        "n_splats": n,
        "intersections_full_frame": inter,
        "resolution": [H, W],
        "scene": "clustered shells + slab + dome (quality_bench GT)",
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("metric", "value", "unit")}), flush=True)
    return out


if __name__ == "__main__":
    main()
