"""Time the port's ``Trainer`` step at chip_smoke.py's phase 7 configuration,
for one or more checkouts of the repo in turn, on one card.

    python3 trainer_step_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (for example the parent commit unpacked with
``git archive`` beside this one; list one twice to interleave, as in
``parent change change parent``). Each runs in a process of its own, which
imports that checkout's ``tinysplat_torch`` and ``chip_smoke``, builds its
kernels, trains phase 7's run on the bench scene (262,144 splats, 4 views at
1066x1600, grad_reduce "mxu", densify growing the capacity to 1,048,576) and
then times ``ROUNDS`` x ``STEPS`` further steps, the card synchronized around
each. Prints the card's name and power limit, then one JSON line per
checkout. Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROUNDS, STEPS = 3, 5


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as c
    import tinysplat_torch as tt
    from tinysplat_torch.config import Config
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.io.checkpoint import load_model
    from tinysplat_torch.ops import _build
    from tinysplat_torch.render import render
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bench_scene.npz")
        c.write_bench_checkpoint(ckpt)
        state = load_model(ckpt, device="cuda")
        start = load_model(ckpt, device="cuda")
    deg, bg = state.active_sh_degree, torch.zeros(3, device="cuda")
    cams = orbit_cameras(c.TRAIN_VIEWS, width=c.WIDTH, height=c.HEIGHT)
    views = [cam.params(device="cuda") for cam in cams]
    with torch.no_grad():
        gts = [render(state.params, state.alive, v, c.HEIGHT, c.WIDTH, deg, bg,
                      **c.RENDER_KW)[0] for v in views]
    for cam, gt in zip(cams, gts):
        cam._image = gt.cpu().numpy()
    noise = np.random.default_rng(7).normal(0.0, 0.1, size=tuple(start.params.colors_dc.shape))
    with torch.no_grad():  # phase 7's start: dimmed opacities, perturbed colours
        live = start.alive[:, None]
        start.params.opacities[:] = torch.where(live, -1.0, start.params.opacities)
        start.params.colors_dc += torch.where(
            live, torch.as_tensor(noise, dtype=torch.float32, device="cuda"), 0.0)
    base = Config(background="black", warmup_grad=0, grad_reduce="mxu", **c.TRAINER_KW)
    tt.init_opt_state(base, start)
    tau = c.calibrated_tau(torch, tt, start, views, gts, base)
    cfg = dataclasses.replace(
        base, tau_means=tau, warmup_densify=c.TRAINER_VIEWS_PER_DENSIFY,
        densify_end=2 * c.TRAINER_VIEWS_PER_DENSIFY, interval_opacity_reset=8,
        nan_guard_interval=4, max_iter=c.TRAINER_STEPS)
    tr = Trainer(cfg, Scene(cams), start)
    tr.run(c.TRAINER_STEPS)
    rounds = []
    for _ in range(ROUNDS):
        times = []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rounds.append(times)
    flat = [t for r in rounds for t in r]
    return {"root": root, "median_ms": statistics.median(flat),
            "round_medians_ms": [statistics.median(r) for r in rounds], "steps_ms": flat,
            "live": int(tr.state.num_live()), "capacity": tr.state.capacity,
            "step": tr.step}


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(os.path.abspath(argv[1]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
