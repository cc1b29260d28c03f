"""The two kinds of traffic a mix file can ask for (its ``kind``), each a
general driver of the program under test that the mix's parameters steer:

- ``train``: a ``Trainer`` of the configuration's trainee on ``views``
  orbit views whose ground truth is the reference's render of the clean
  cloud; set-up drives it through ``checked_steps`` (the steps the
  reference follows) and ``warmup_steps``, then the window runs
  ``Trainer.train_step()`` back to back (a closed loop).
- ``serve``: the trainee served by a ``Trainer`` (no training); set-up
  renders every pose ``warmup_passes`` times, then the window renders
  ``poses`` novel orbit poses in turn, each ``Trainer.render_camera`` over
  ``background`` and the RGB copied into the client's host buffer (no
  JPEG), one client waiting for each frame (a closed loop).

Each driver returns a ``Run``: its end-to-end numbers, what the reference
check needs, and what the traced window saw. A training cell's check is
its configuration's objective's (``objectives/``): ``check(TrainInputs)``;
a serving cell's renders by the objective's ``render`` where it has one.
A kind this file lacks is a file of ``drivers/`` (``spec.kind``).
"""
from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import inputs
from . import trace as tr
from .reference import render as R
from .reference import train as RT


class Run(NamedTuple):
    e2e: Dict[str, float]  # end-to-end numbers, by metric name
    attempted: int
    failed: int
    peak_bytes: int
    check: Callable[[], Dict[str, float]]  # run once the program is freed
    trace: Optional[tr.Trace]
    calls: int  # traced steps or frames
    call_s: float  # the measured window's seconds a step or frame
    work: Callable[[], List[dict]]  # the traced calls' counts (reference)
    notes: Dict[str, object]  # printed on an earlier line


class TrainInputs(NamedTuple):
    """What a training objective's ``check`` and ``reference`` are given.

    ``program``, what the program did in the checked steps: ``losses`` (each
    step's loss), ``grad`` and ``change`` (by leaf, the first gradient's norm
    and the change's norm over the steps), ``terms`` (each step's ``loss_*``
    metrics by name), ``live`` (the live count after each step), ``densify``
    and ``probe`` (the Trainer's ``densify_history`` and ``probe_history``
    entries of those steps). The control hands the reference's record in its
    place.
    """

    trainee: Dict[str, torch.Tensor]  # the leaves the checked steps start from
    cameras: List[R.Camera]  # each checked step's camera
    gts: List[torch.Tensor]  # each checked step's ground truth (H, W, 3)
    steps: List[int]  # the checked steps' numbers (1-based, as the Trainer counts)
    seed: int  # inputs.seed64(--seed): Config.seed, the Trainer's generator's seed
    config: dict  # the program's Config fields: the configuration's ``program``,
    #               the mix's ``trainer`` over it, ``sh_degree``
    tile: Tuple[int, int]  # tile height, width
    device: torch.device
    program: Optional[dict]  # what the program did in the checked steps


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.empty(0, device=dev)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _program_config(cell, seed: int, extra: dict):
    from tinysplat_torch.config import Config

    return Config(**cell.config["program"], **extra, sh_degree=int(cell.config["sh_degree"]),
                  seed=inputs.seed64(seed))


def _program_state(params: Dict[str, torch.Tensor], sh_degree: int):
    from tinysplat_torch.models.gaussians import GaussianParams, GaussianState

    n = params["means"].shape[0]
    dev = params["means"].device
    return GaussianState(params=GaussianParams(**{k: params[k] for k in inputs.LEAVES}),
                         alive=torch.ones(n, dtype=torch.bool, device=dev),
                         means_grad_accum=torch.zeros(n, device=dev),
                         active_sh_degree=torch.tensor(sh_degree, dtype=torch.int32,
                                                       device=dev))


def _program_camera(c: inputs.OrbitCamera, image=None):
    from tinysplat_torch.cameras import Camera

    return Camera(position=c.position, f_x=c.fx, f_y=c.fy, fov_x=c.fov_x, fov_y=c.fov_y,
                  view_matrix=c.view, width=c.width, height=c.height, name=c.name,
                  image=image)


def _trainee(cell, seed: int, dev) -> Dict[str, torch.Tensor]:
    return inputs.jitter(inputs.make_cloud(cell.config, seed, dev),
                         cell.traffic["jitter_std"], seed)


def _tiles(cell):
    p = cell.config["program"]
    return int(p["tile_size"]), int(p["tile_x"] or p["tile_size"])


def _budgets(cell):
    return {k: cell.config["program"][k]
            for k in ("dup_capacity", "max_per_tile", "span_capacity")}


@torch.no_grad()
def ground_truth(cell, seed: int, views, dev) -> List[np.ndarray]:
    """The reference's render of the clean cloud at each view over black."""
    cloud = inputs.make_cloud(cell.config, seed, dev)
    th, tw = _tiles(cell)
    out = []
    with RT.full_float32():
        for v in views:
            img, _ = R.render(cloud, R.camera(v, dev), torch.zeros(3, device=dev), th, tw,
                              _budgets(cell))
            out.append(img.cpu().numpy())
    return out


def train_inputs(cell, seed: int, views, gts, dev,
                 program: Optional[dict] = None) -> TrainInputs:
    """The checked steps of a training cell, as its objective is given them."""
    t = cell.traffic
    start = int(t["start_step"])
    steps = list(range(start + 1, start + 1 + int(t["checked_steps"])))
    idx = scene_cameras(len(views), seed, steps)
    return TrainInputs(_trainee(cell, seed, dev), [R.camera(views[i], dev) for i in idx],
                       [torch.as_tensor(gts[i], device=dev) for i in idx], steps,
                       inputs.seed64(seed),
                       dict(cell.config["program"], **t["trainer"],
                            sh_degree=int(cell.config["sh_degree"])),
                       _tiles(cell), dev, program)


def scene_cameras(n: int, seed: int, steps) -> List[int]:
    """The view index of each 1-based step: a fresh permutation of the views
    an epoch, numpy's ``default_rng(seed + epoch)``, step s drawing index
    s - 1 (the program's documented sampler)."""
    out = []
    for s in steps:
        epoch, pos = divmod(s - 1, n)
        out.append(int(np.random.default_rng(inputs.seed64(seed) + epoch).permutation(n)[pos]))
    return out


def train(cell, seed: int, seconds: float, trace: bool, dev, t0: float) -> Run:
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    t = cell.traffic
    views = inputs.training_views(cell.config, t)
    gts = ground_truth(cell, seed, views, dev)
    marks = {"inputs": time.perf_counter() - t0}
    _free(dev)
    _reset_peak(dev)
    params = _trainee(cell, seed, dev)
    initial = {k: v.clone() for k, v in params.items()}
    conf = _program_config(cell, seed, t["trainer"])
    start = int(t["start_step"])
    trainer = Trainer(conf, Scene([_program_camera(v, g) for v, g in zip(views, gts)],
                                  seed=inputs.seed64(seed)),
                      _program_state(params, int(cell.config["sh_degree"])), start_step=start)
    del params
    marks["trainer"] = time.perf_counter() - t0

    # The checked steps: the objective's reference follows these from ``initial``.
    losses, terms, live, first_grad = [], [], [], None
    refines, probes = len(trainer.densify_history), len(trainer.probe_history)
    for i in range(int(t["checked_steps"])):
        trainer.train_step()
        m = trainer.last_metrics
        losses.append(m["loss"].detach().clone())
        terms.append({k: v.clone() for k, v in m.items() if k.startswith("loss_")})
        live.append(trainer.state.num_live())
        if i == 0:
            mu = trainer.opt_state.moments()[0]
            first_grad = {k: (mu[k] / (1.0 - RT.BETAS[0])).norm() for k in inputs.LEAVES}
    state = trainer.state.params
    change = {k: (getattr(state, k).detach() - initial[k]).norm() for k in inputs.LEAVES}
    checked = dict(losses=[float(x) for x in losses],
                   grad={k: float(v) for k, v in first_grad.items()},
                   change={k: float(v) for k, v in change.items()},
                   terms=[{k: float(v) for k, v in d.items()} for d in terms],
                   live=[int(x) for x in live],
                   densify=[dict(e) for e in trainer.densify_history[refines:]],
                   probe=[dict(e) for e in trainer.probe_history[probes:]])
    del initial
    marks["checked"] = time.perf_counter() - t0
    for _ in range(int(t["warmup_steps"])):
        trainer.train_step()
    _sync(dev)

    def diag():
        m = trainer.last_metrics
        return int(m["num_live"]), int(m["n_intersections"])

    live0, inter0 = diag()
    rollbacks0 = trainer._rollbacks
    refines, probes = len(trainer.densify_history), len(trainer.probe_history)
    prof, traced_steps, snapshot, ends = None, [], None, []
    t_start = time.perf_counter()
    steps = 0
    while True:
        if trace and prof is None and time.perf_counter() - t_start >= seconds / 2:
            # The traced steps: the state they start from is kept for the
            # reference's count of their work.
            _sync(dev)
            snapshot = {k: getattr(trainer.state.params, k).detach().clone()
                        for k in inputs.LEAVES}
            traced_steps = list(range(trainer.step + 1,
                                      trainer.step + 1 + int(t["trace_steps"])))
            prof = tr.start(dev)
        trainer.train_step()
        steps += 1
        ends.append(time.perf_counter())
        if traced_steps and trainer.step == traced_steps[-1]:
            tr.stop(prof, dev)
        if ends[-1] - t_start >= seconds and (not trace or traced_steps) and (
                not traced_steps or trainer.step >= traced_steps[-1]):
            break
    _sync(dev)
    window = time.perf_counter() - t_start
    live1, inter1 = diag()
    third = max(len(ends) // 3, 1)
    notes = dict(setup_s=t_start - t0, setup_marks=marks, live_start=live0, live_end=live1,
                 intersections_start=inter0, intersections_end=inter1, steps=steps,
                 window_s=window,
                 first_third_ms=1e3 * (ends[third - 1] - t_start) / third,
                 last_third_ms=1e3 * (ends[-1] - ends[-third - 1]) / third,
                 step_at_end=trainer.step,
                 refine_passes=len(trainer.densify_history) - refines,
                 probe_refreshes=len(trainer.probe_history) - probes,
                 budgets={k: getattr(trainer.cfg, k) for k in _budgets(cell)})
    failed = trainer._rollbacks - rollbacks0
    peak = _peak(dev)
    del trainer, state
    _free(dev)
    traced = tr.Trace(prof) if prof is not None else None
    del prof

    th, tw = _tiles(cell)

    def check() -> Dict[str, float]:
        return cell.objective.check(train_inputs(cell, seed, views, gts, dev, checked))

    def work() -> List[dict]:
        if snapshot is None:
            return []
        idx = scene_cameras(len(views), seed, traced_steps)
        out = []
        with RT.full_float32(), torch.no_grad():
            for i in idx:
                s = R.project(snapshot, R.camera(views[i], dev))
                out.append(R.count_work(s, R.bin_tiles(s, cell.config["height"],
                                                        cell.config["width"], th, tw)))
        return out

    return Run({"train_step_ms": 1e3 * window / steps}, steps, failed, peak, check, traced,
               len(traced_steps), window / steps, work, notes)


def serve(cell, seed: int, seconds: float, trace: bool, dev, t0: float) -> Run:
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    t = cell.traffic
    poses = inputs.novel_poses(cell.config, t)
    views = inputs.training_views(cell.config, t)
    _reset_peak(dev)
    conf = _program_config(cell, seed, t.get("trainer", {}))
    trainer = Trainer(conf, Scene([_program_camera(v) for v in views], seed=inputs.seed64(seed)),
                      _program_state(_trainee(cell, seed, dev), int(cell.config["sh_degree"])))
    # A frame: the trainer's render over black (what the live viewer binds
    # to its scene), then the RGB copied into the client's host buffer
    # (pinned, allocated once: a copy to fresh pageable memory runs at the
    # host's memory bandwidth, which other tenants of the machine move by
    # 2-3x between runs).
    black = torch.tensor(t["background"], dtype=torch.float32, device=dev)
    host = torch.empty((cell.config["height"], cell.config["width"], 3),
                       pin_memory=dev.type == "cuda")

    def frame(cam) -> np.ndarray:
        rgb, _ = trainer.render_camera(cam, background=black)
        host.copy_(rgb)
        return host.numpy()

    cams = [_program_camera(p) for p in poses]

    marks = {"trainer": time.perf_counter() - t0}
    for _ in range(int(t["warmup_passes"])):
        for cam in cams:
            frame(cam)
    # Frames kept for the check: poses drawn from the seed, each at a pass
    # over the poses drawn from the seed too.
    rng = np.random.default_rng(inputs.seed64(seed))
    sample = rng.choice(len(cams), size=int(t["checked_frames"]), replace=False)
    target = {int(p): int(rng.integers(0, int(t["checked_pass_max"]) + 1)) for p in sample}
    kept: Dict[int, np.ndarray] = {}
    lat: List[float] = []
    prof, traced_poses, trace_end = None, [], -1
    i = 0
    _sync(dev)
    t_start = time.perf_counter()
    while True:
        if trace and prof is None and time.perf_counter() - t_start >= seconds / 2:
            _sync(dev)
            trace_end = i + int(t["trace_frames"])
            prof = tr.start(dev)
        p = i % len(cams)
        a = time.perf_counter()
        img = frame(cams[p])
        b = time.perf_counter()
        if prof is not None and i < trace_end:
            traced_poses.append(p)
        else:
            lat.append(b - a)
        if target.get(p) == i // len(cams):
            kept[p] = img.copy()
        i += 1
        if i == trace_end:
            tr.stop(prof, dev)
        if b - t_start >= seconds and (not trace or (prof is not None and i >= trace_end)):
            break
    window = time.perf_counter() - t_start
    frames = i
    peak = _peak(dev)
    ms = 1e3 * np.asarray(lat)
    slow = ms > 2 * np.median(ms)
    notes = dict(setup_s=t_start - t0, setup_marks=marks, frames=frames, window_s=window,
                 passes=frames / len(cams),
                 frame_ms={q: float(np.percentile(ms, q)) for q in (50, 90, 95, 99, 100)},
                 slow_frames=int(slow.sum()),
                 frames_each_second=np.bincount((np.cumsum(lat) // 1.0).astype(int)).tolist(),
                 frames_kept=len(kept))
    del trainer
    _free(dev)
    traced = tr.Trace(prof) if prof is not None else None
    del prof
    th, tw = _tiles(cell)

    render = reference_render(cell)

    def check() -> Dict[str, float]:
        p = _trainee(cell, seed, dev)
        if len(kept) < len(target):  # a sampled frame never came in the window
            return {"frame_max_gap": math.inf, "frame_mean_gap": math.inf}
        gaps_max, gaps_mean = [], []
        with RT.full_float32(), torch.no_grad():
            for pose, img in sorted(kept.items()):
                ref, _ = render(p, R.camera(poses[pose], dev), black, th, tw)
                d = (torch.as_tensor(img, device=dev) - ref).abs()
                gaps_max.append(float(d.max()))
                gaps_mean.append(float(d.mean()))
        return {"frame_max_gap": max(gaps_max), "frame_mean_gap": max(gaps_mean)}

    def work() -> List[dict]:
        p = _trainee(cell, seed, dev)
        out = []
        with RT.full_float32(), torch.no_grad():
            for pose in traced_poses:
                s = R.project(p, R.camera(poses[pose], dev))
                out.append(R.count_work(s, R.bin_tiles(s, cell.config["height"],
                                                        cell.config["width"], th, tw)))
        return out

    e2e = {"frames_per_s": frames / window,
           "frame_ms_p95": 1e3 * float(np.percentile(lat, 95))}  # untraced frames
    return Run(e2e, frames, 0, peak, check, traced, len(traced_poses), window / frames, work,
               notes)


def reference_render(cell):
    """The render a serving cell's check follows: its objective's, else the
    plain reference's."""
    return getattr(cell.objective, "render", R.render)


def train_control(cell, seed: int, dev) -> Dict[str, float]:
    """The objective's ``reference`` in TF32 stands as the program's record
    of the checked steps, and its ``check`` judges it."""
    views = inputs.training_views(cell.config, cell.traffic)
    base = train_inputs(cell, seed, views, ground_truth(cell, seed, views, dev), dev)
    with R.tf32():
        low = cell.objective.reference(base)
    return cell.objective.check(base._replace(program=low))


@torch.no_grad()
def serve_control(cell, seed: int, dev) -> Dict[str, float]:
    """The check's sampled poses rendered in TF32, against float32."""
    t = cell.traffic
    poses = inputs.novel_poses(cell.config, t)
    rng = np.random.default_rng(inputs.seed64(seed))
    sample = rng.choice(len(poses), size=int(t["checked_frames"]), replace=False)
    p = _trainee(cell, seed, dev)
    th, tw = _tiles(cell)
    render = reference_render(cell)
    bg = torch.tensor(t["background"], dtype=torch.float32, device=dev)
    gmax, gmean = [], []
    with RT.full_float32():
        for pose in sorted(int(x) for x in sample):
            cam = R.camera(poses[pose], dev)
            ref, _ = render(p, cam, bg, th, tw)
            with R.tf32():
                low, _ = render(p, cam, bg, th, tw)
            d = (low - ref).abs()
            gmax.append(float(d.max()))
            gmean.append(float(d.mean()))
    return {"frame_max_gap": max(gmax), "frame_mean_gap": max(gmean)}


# The kinds this file drives, each as a ``drivers/<kind>.py`` file gives
# one (``spec.kind``): ``run``, the names its check returns where the
# configuration's objective does not give them, and the ``control``.
KINDS = {
    "train": SimpleNamespace(run=train, CHECKS=(), control=train_control),
    "serve": SimpleNamespace(run=serve, CHECKS=("frame_max_gap", "frame_mean_gap"),
                             control=serve_control),
}
