"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which raises on failure (nothing catches it, so the script
exits non-zero):

1. The card (nvidia-smi name and power limit), torch and CUDA versions.
2. Build every CUDA kernel from ``tinysplat_torch/csrc`` (nvcc, sm_90a).
3. Hold K1 (``composite_fwd``) against its plain PyTorch version on small
   synthetic cases: mixed scenes at tile widths 16 and 64, heavy occlusion
   that saturates T, a tile deeper than one batch, mostly empty tiles.
4. Serve frames at full width: the bench scene (262,144 splats, SH degree
   3, 1066x1600) written as a JAX-layout ``.npz`` checkpoint, loaded with
   ``load_model`` and rendered along an orbit through ``render``. The launch
   counts show the frames went through K1; the frames are checked, and K1
   is held against its plain version and timed at the frames' own shapes.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N_SPLATS = 1 << 18
HEIGHT, WIDTH = 1066, 1600
FRAMES, WARMUP = 8, 2
# Binning budgets of the bench scene at 64x16 tiles, with headroom and no
# dropped entries (the JAX package's bench.py sizes them the same way).
RENDER_KW = dict(tile_x=64, dup_capacity=760_000, span_capacity=786_432,
                 max_per_tile=4096)
# K1 and its plain version round the same float32 ops in the same order, so
# they should agree bit for bit; 1e-5 (relative above 1: the depth channel)
# bounds what a different exp() in another CUDA build could move.
KERNEL_TOL = 1e-5
MATCH_SHARE = 0.9999  # n_contrib / last_contrib equal at >= this share of pixels
# H100 SXM published peaks (data sheet; full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# FP32 operations K1 spends on every (entry, pixel) pair it evaluates:
# dx, dy (2), sigma (9), exp (1), opacity * exp (1), min (1) and the sigma
# and alpha tests (2). Contributing pairs cost 12 more; not counted, so the
# bound stays a lower bound.
FLOP_PER_PAIR = 16


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, reps):
    """Median of per-call CUDA-event times (ms) over ``reps`` calls."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_kernel(torch, rc, args, label):
    """K1 vs its plain version on the same inputs; raises past tolerance.

    Returns (max abs error of rows c0..c3 and T_final, kernel output)."""
    got = rc.composite_fwd(*args)
    ref = rc.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    diff = (got[:, 0:5] - ref[:, 0:5]).abs()
    max_err = float(diff.max()) if diff.numel() else 0.0
    scaled = float((diff / ref[:, 0:5].abs().clamp(min=1.0)).max()) if diff.numel() else 0.0
    share = float((got[:, 5:7] == ref[:, 5:7]).float().mean()) if diff.numel() else 1.0
    walked = int(torch.minimum(got[:, 5] + 1, args[3][:, None].float()).sum())
    print(f"  {label}: tiles {got.shape[0]}, max entries/tile {int(args[3].max())}, "
          f"max|K1-plain| {max_err:.3e} (scaled {scaled:.3e}, tol {KERNEL_TOL:g}), "
          f"n_contrib/last_contrib equal {share:.6f} (need >= {MATCH_SHARE}), "
          f"pairs walked {walked}", flush=True)
    if not (scaled <= KERNEL_TOL and share >= MATCH_SHARE):
        raise AssertionError(f"K1 disagrees with its plain version on {label}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K1 wrote non-finite values on {label}")
    return max_err, got


def synthetic_case(torch, rc, label, n, height, width, tile_x, seed, xy_lo=None,
                   xy_hi=None, conic=None, opacity=(0.05, 1.0), **caps):
    """K1's inputs for n random screen-space splats (numpy draws)."""
    rng = np.random.default_rng(seed)
    lo = xy_lo if xy_lo is not None else (-6.0, -6.0)
    hi = xy_hi if xy_hi is not None else (width + 6.0, height + 6.0)
    xys = rng.uniform(lo, hi, size=(n, 2)).astype(np.float32)
    depths = rng.uniform(0.5, 5.0, size=(n,)).astype(np.float32)
    if conic is None:
        L = rng.normal(size=(n, 2, 2)).astype(np.float32) * 2.0
        cov = L @ np.swapaxes(L, 1, 2) + np.eye(2, dtype=np.float32)
    else:
        cov = np.tile(np.linalg.inv(np.asarray(conic, np.float32)), (n, 1, 1))
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], axis=1)
    radii = np.ceil(3.5 * np.sqrt(np.linalg.eigvalsh(cov).max(axis=1)))
    colors = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
    opac = rng.uniform(*opacity, size=(n,)).astype(np.float32)
    valid = rng.uniform(size=(n,)) > 0.05

    def cuda(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    f32 = torch.float32
    return label, rc.tile_inputs(
        cuda(xys, f32), cuda(depths, f32), cuda(radii, torch.int32), cuda(conics, f32),
        cuda(colors, f32), cuda(opac, f32), cuda(valid, torch.bool), height, width,
        tile_x=tile_x, **caps)


def where_the_time_goes(torch, frame_ms, layers):
    """Each layer of a frame timed on its own (CUDA events, median of 5),
    beside the frame: what the layers leave over is host time between them."""
    total = 0.0
    for name, fn in layers.items():
        ms = timed_ms(torch, fn, 5)
        total += ms
        print(f"  layer {name}: {ms:.3f} ms", flush=True)
    print(f"  layers sum {total:.3f} ms of a {frame_ms:.3f} ms frame", flush=True)


def write_bench_checkpoint(path, seed=0):
    """The bench scene as a JAX-layout checkpoint: model/* arrays of the
    compact live-splat snapshot (what save_checkpoint writes)."""
    from tinysplat_torch.data.synthetic import random_gaussian_cloud
    from tinysplat_torch.utils.color import RGB2SH

    means, log_scales, quats, colors, opac = random_gaussian_cloud(
        N_SPLATS, seed=seed, scale_range=(0.002, 0.01))
    rest = np.random.default_rng(seed + 1).normal(size=(N_SPLATS, 15, 3)) * 0.05
    np.savez(path, **{
        "model/means": means,
        "model/colors_dc": RGB2SH(colors).astype(np.float32),
        "model/colors_rest": rest.astype(np.float32),
        "model/scales": log_scales,
        "model/quats": quats,
        "model/opacities": opac,
        "model/active_sh_degree": np.asarray(3, np.int32),
    })


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.io.checkpoint import load_model
    from tinysplat_torch.ops import _build
    from tinysplat_torch.ops import rasterize_cuda as rc
    from tinysplat_torch.render import render, splat_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ---------------------------------------------------------
    print(gpu_name_and_limit(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for {sorted(libs)}", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name} ptxas: {line.strip()}", flush=True)

    # -- 3. K1 vs plain on small synthetic cases -------------------------------
    print("phase 3: K1 vs plain, synthetic cases", flush=True)
    cases = [
        synthetic_case(torch, rc, "mixed tile_x=16", 3000, 96, 256, 16, seed=1),
        synthetic_case(torch, rc, "mixed tile_x=64", 3000, 96, 256, 64, seed=1),
        synthetic_case(torch, rc, "heavy occlusion tile_x=64", 4000, 64, 128, 64, seed=2,
                       conic=[[0.02, 0.0], [0.0, 0.02]], opacity=(0.9, 1.0)),
        synthetic_case(torch, rc, "deep tile tile_x=32", 3000, 32, 64, 32, seed=3,
                       xy_lo=(0.0, 0.0), xy_hi=(32.0, 16.0),
                       conic=[[0.001, 0.0], [0.0, 0.001]], opacity=(0.004, 0.008),
                       max_per_tile=4096),
        synthetic_case(torch, rc, "mostly empty tile_x=64", 40, 128, 1024, 64, seed=4,
                       conic=[[2.0, 0.0], [0.0, 2.0]]),
    ]
    for label, ti in cases:
        args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, ti.tile_x)
        compare_kernel(torch, rc, args, label)
    deep = cases[3][1]
    if int(deep.counts.max()) <= 16 * 32:
        raise AssertionError("the deep-tile case must exceed one batch of entries")

    # -- 4. serving at full width ----------------------------------------------
    print(f"phase 4: serve {FRAMES} frames, {N_SPLATS} splats, {HEIGHT}x{WIDTH}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bench_scene.npz")
        write_bench_checkpoint(ckpt)
        t0 = time.perf_counter()
        state = load_model(ckpt, device="cuda")
        torch.cuda.synchronize()
        print(f"  load_model: {time.perf_counter() - t0:.3f} s, capacity {state.capacity}, "
              f"active SH degree {int(state.active_sh_degree)}", flush=True)
    deg = state.active_sh_degree
    bg = torch.zeros(3, device="cuda")
    cams = [c.params(device="cuda") for c in orbit_cameras(FRAMES, width=WIDTH, height=HEIGHT)]

    def frame(cam):
        with torch.no_grad():
            return render(state.params, state.alive, cam, HEIGHT, WIDTH, deg, bg, **RENDER_KW)

    for cam in cams[:WARMUP]:
        frame(cam)
    torch.cuda.synchronize()

    rc.composite_fwd.launches = 0
    frame_ms, host_ms, results = [], [], []
    for cam in cams:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        rgb, extras = frame(cam)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        frame_ms.append(start.elapsed_time(end))
        results.append((rgb, extras))
    launches = rc.composite_fwd.launches
    print(f"  composite_fwd launches during the {FRAMES} frames: {launches}", flush=True)
    if launches != FRAMES:
        raise AssertionError(f"expected {FRAMES} K1 launches, counted {launches}")

    depth_medians = []
    for i, (rgb, ex) in enumerate(results):
        diag = ex["binning"]
        if diag["dup_dropped"] or diag["tile_dropped"]:
            raise AssertionError(f"frame {i} dropped entries: {diag}")
        alpha, depth = ex["alpha"], ex["depth"]
        if rgb.shape != (HEIGHT, WIDTH, 3) or not torch.isfinite(rgb).all():
            raise AssertionError(f"frame {i}: bad rgb {tuple(rgb.shape)}")
        if float(rgb.min()) < 0.0 or float(rgb.max()) > 1.0:
            raise AssertionError(f"frame {i}: rgb outside [0, 1]")
        coverage = float((alpha > 0.01).float().mean())
        opaque = alpha > 0.9
        if coverage <= 0.0 or not bool(opaque.any()):
            raise AssertionError(f"frame {i}: nothing rendered")
        depth_medians.append(float((depth[opaque] / alpha[opaque]).median()))
    print(f"  alpha coverage frame 0: {float((results[0][1]['alpha'] > 0.01).float().mean()):.4f}; "
          f"median depth at opaque pixels per frame: "
          f"{[round(d, 4) for d in depth_medians]} (orbit radius 3.0)", flush=True)
    if not all(abs(d - 3.0) < 1.0 for d in depth_medians):
        raise AssertionError("depth at opaque pixels is not near the orbit radius")

    # K1 at the main path's shapes: frame 0's inputs, against the plain
    # version (launches here are outside the counted window).
    s = splat_inputs(state.params, state.alive, cams[0], HEIGHT, WIDTH, deg, bg)
    ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
                        s.opacities, s.valid, HEIGHT, WIDTH, **RENDER_KW)
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, ti.tile_x)
    max_err, out = compare_kernel(torch, rc, args, "bench frame 0")
    plain_out = rc.composite_fwd_plain(*args)
    img_p, alpha_p = rc.untile(plain_out, s.bg4, ti.tiles_x, ti.tiles_y, ti.tile_x,
                               HEIGHT, WIDTH)
    rgb0, ex0 = results[0]
    frame_err = max(float((rgb0 - img_p[..., :3].clamp(max=1.0)).abs().max()),
                    float((ex0["alpha"] - alpha_p).abs().max()))
    print(f"  frame 0 through render() vs the plain version: max abs diff {frame_err:.3e}",
          flush=True)
    if frame_err > KERNEL_TOL:
        raise AssertionError("the served frame disagrees with the plain version")

    k1_ms = timed_ms(torch, lambda: rc.composite_fwd(*args), 20)
    plain_ms = timed_ms(torch, lambda: rc.composite_fwd_plain(*args), 3)
    pairs = int(torch.minimum(out[:, 5] + 1, ti.counts[:, None].float()).sum())
    tile_pairs = int(ti.counts.long().sum()) * 16 * ti.tile_x
    in_bytes = sum(x.numel() * x.element_size() for x in args[:6])
    out_bytes = out.numel() * out.element_size()
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = pairs * FLOP_PER_PAIR / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    intersections = [ex["binning"]["intersections"] for _, ex in results]
    med_frame = statistics.median(frame_ms)
    print(f"  frame: median {med_frame:.3f} ms (CUDA events), host median "
          f"{statistics.median(host_ms):.3f} ms, {1e3 / med_frame:.2f} frames/s; "
          f"intersections per frame {intersections}", flush=True)
    print(f"  K1 at frame 0: median {k1_ms:.4f} ms over 20 launches; plain version "
          f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"(bytes {in_bytes + out_bytes} -> {bytes_ms:.4f} ms, {pairs} pairs walked x "
          f"{FLOP_PER_PAIR} FLOP -> {ops_ms:.4f} ms; all entries x pixels {tile_pairs})",
          flush=True)
    binning_ms = timed_ms(torch, lambda: rc.bin_splats_dense(
        s.xys, s.proj.depths, s.proj.radii, s.valid, ti.tiles_x, ti.tiles_y,
        conics=s.proj.conics, opacities=s.opacities, tile_size_x=ti.tile_x,
        **{k: v for k, v in RENDER_KW.items() if k != "tile_x"}), 5)
    print(f"  binning alone (bin_splats_dense): {binning_ms:.3f} ms", flush=True)
    where_the_time_goes(torch, med_frame, {
        "splat_inputs (projection, SH, opacities)": lambda: splat_inputs(
            state.params, state.alive, cams[0], HEIGHT, WIDTH, deg, bg),
        "tile_inputs (binning, table, tile origins)": lambda: rc.tile_inputs(
            s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4, s.opacities,
            s.valid, HEIGHT, WIDTH, **RENDER_KW),
        "composite_fwd (K1)": lambda: rc.composite_fwd(*args),
        "untile": lambda: rc.untile(out, s.bg4, ti.tiles_x, ti.tiles_y, ti.tile_x,
                                    HEIGHT, WIDTH),
    })

    record = {"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "tinysplat_torch/csrc/composite_fwd.cu",
        "replaces": "tinysplat_tpu/ops/rasterize_pallas.py:781",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
