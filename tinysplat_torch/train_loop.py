"""Host-side training orchestration around the train step.

Torch port of ``tinysplat_tpu.train_loop``. What stays on the host:

- camera sampling per step (``Scene.get_random_camera``, a pure function of
  (seed, step), so a resumed run replays the same cameras);
- the per-camera ground-truth cache on the device, warmed by a thread pool;
- the coarse-to-fine resolution schedule and its intrinsics scaling;
- the densify / prune cadence, with capacity growth when densification
  runs out of free slots (grow, then redo the pass), periodic compaction
  and the opacity reset; under ``densify_strategy="mcmc"`` the refine pass
  is ``relocate_and_grow`` instead, on every ``cfg.mcmc_refine_every``-th
  step where that is set (else on the densify interval), and capacity
  never grows, compaction and the opacity reset are skipped;
- the density-probe refresh of ``regularize_density``: at the window start
  the splats below opacity 0.5 are pruned; the probe (sample points, their
  KNN) is rebuilt at the start, on every step with
  ``step % cfg.interval_densify == 1`` and whenever it was dropped
  (compaction permutes rows, so it drops the probe);
- the per-camera pose / appearance Adams of ``pose_opt`` / ``app_opt``;
- the binning-budget retune, the NaN guard (snapshot and rollback), sync and
  async checkpoints, held-out evaluation and a ``torch.profiler`` window;
- ``run_async``: the steps in an executor thread beside the live viewer's
  event loop. A lock held across each step and across ``render_camera``
  makes a frame rendered from another thread see a whole step (the
  in-place Adam, densify and reset writes never half-applied), and the
  render draws nothing from the trainer's generator.

PyTorch runs eagerly, so there is no step cache: the step is rebuilt from
``self.cfg`` each time, and a budget retune (a new ``cfg``) takes effect at
the next step. Metrics stay device tensors and are read at epoch
boundaries. Densify, prune and the opacity reset edit the parameter tensors
and Adam moments in place; growth, compaction and a rollback make new
tensors and rebuild the optimizer (``GaussianAdam.carried``).

The sharded trainer (``parallel.MeshTrainer``) runs this loop on every
rank and overrides its hooks: ``_whole_state`` (the host passes that need
every splat: densify with growth, compaction, the density-probe refresh),
``_invalidate_step_cache``, ``_c2f_height_quantum``, ``_global_capacity``
and ``_budget_bands``. The metrics file is written by rank 0 only.

The diffusion views of ``regularize_diffusion``
(``regularizers.diffusion_guidance``): on cadence inside the window, novel
views rendered by the current model and refined by the diffusion pipeline
join the scene as synthetic cameras; the window's end removes them. A
refresh runs inside the step's lock (``render_camera`` re-enters it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .cameras import Camera, apply_pose_delta
from .config import Config
from .models.densify import densify_and_prune, prune_by_mask, reset_opacities
from .models.densify_mcmc import relocate_and_grow
from .models.gaussians import GaussianParams, GaussianState, compact_state, grow_capacity
from .ops.ssim import psnr, ssim
from .regularizers.density import make_density_probe
from .render import render
from .scene import Scene
from .train import (
    fixed_background,
    init_opt_state,
    make_train_step,
    optimizer_with_moments,
)
from .utils import profiling
from .utils.device import synchronize
from .utils.profiling import kernel_busy_share  # noqa: F401 (re-exported)
from .utils.profiling import span

log = logging.getLogger(__name__)


def grow_opt_state(opt_state, state: GaussianState):
    """The optimizer of ``state`` (just grown by ``grow_capacity``) with
    every capacity-sized Adam moment zero-padded to its capacity."""
    cap = state.capacity

    def pad(m):
        return torch.cat([m, m.new_zeros((cap - m.shape[0],) + tuple(m.shape[1:]))])

    return opt_state.carried(state.params, pad)


class Metrics:
    """Per-step device scalars, logged as means over the last epoch (one
    pass over the cameras), with an optional CSV sink: one row per epoch
    boundary, header from the first row's keys."""

    def __init__(self, num_cameras: int, csv_path: Optional[str] = None):
        self.num_cameras = max(num_cameras, 1)
        self._pending: Dict[str, list] = defaultdict(list)
        self._csv_path = csv_path
        self._csv_keys: Optional[list] = None

    def update(self, step: int, values: Dict[str, object]) -> None:
        for k, v in values.items():
            self._pending[k].append(v)

    def log(self, step: int, extra: str = "") -> Optional[str]:
        if step % self.num_cameras != 0:
            return None
        means: Dict[str, float] = {}
        for key, vals in self._pending.items():
            last = torch.stack([torch.as_tensor(v, dtype=torch.float32).reshape(())
                                .to("cpu") for v in vals[-self.num_cameras:]])
            means[key] = float(last.mean())
        self._pending.clear()
        line = " | ".join(f"{k}: {v:<10.4f}" for k, v in means.items())
        line += f" | {extra}" if extra else ""
        log.info("step %d | %s", step, line)
        if self._csv_path and means:
            self._write_csv(step, means)
        return line

    def _write_csv(self, step: int, means: Dict[str, float]) -> None:
        if self._csv_keys is None:
            self._csv_keys = sorted(means)
            header = ",".join(["step"] + self._csv_keys)
            fresh = True
            if os.path.exists(self._csv_path):
                # Resuming into an existing file: rows in another key order
                # would misalign columns, so a mismatched file is rotated.
                with open(self._csv_path) as f:
                    fresh = f.readline().strip() != header
                if fresh:
                    os.replace(self._csv_path, self._csv_path + ".old")
                    log.warning("metrics file key set changed; previous rows moved to %s",
                                self._csv_path + ".old")
            if fresh:
                with open(self._csv_path, "w") as f:
                    f.write(header + "\n")
        with open(self._csv_path, "a") as f:
            f.write(",".join([str(step)] + [f"{means.get(k, float('nan')):.6g}"
                                            for k in self._csv_keys]) + "\n")


def _adam_row(table, m, v, cnt, slot: int, g, lr: float) -> None:
    """One Adam step (torch defaults) on row ``slot`` of a per-camera
    table, in place."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    c = cnt[slot] + 1
    m_s = b1 * m[slot] + (1 - b1) * g
    v_s = b2 * v[slot] + (1 - b2) * g * g
    mhat = m_s / (1 - b1 ** c.to(torch.float32))
    vhat = v_s / (1 - b2 ** c.to(torch.float32))
    table[slot] += -lr * mhat / (torch.sqrt(vhat) + eps)
    m[slot], v[slot], cnt[slot] = m_s, v_s, c


class Trainer:
    """Single-device trainer: the device is the state's."""

    def __init__(self, cfg: Config, scene: Scene, state: GaussianState, opt_state=None,
                 start_step: int = 0, rng_state: Optional[torch.Tensor] = None):
        self.cfg = cfg
        self.scene = scene
        self.state = state
        # Held across a step and across render_camera (see the module doc).
        self._lock = threading.RLock()
        self.device = state.alive.device
        self.opt_state = opt_state if opt_state is not None else init_opt_state(cfg, state)
        self.step = start_step
        # Background, densify split, MCMC and density-probe draws;
        # checkpoints carry its state.
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        if rng_state is not None:
            self.generator.set_state(rng_state)
        # The metrics are replicated over the ranks of a mesh: rank 0 writes them.
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        self.metrics = Metrics(len(scene.cameras),
                               csv_path=(cfg.metrics_file or None) if rank0 else None)
        self._image_cache: Dict[tuple, torch.Tensor] = {}
        self._decode_lock = defaultdict(threading.Lock)  # per camera (PIL decode)
        self._prefetched = False
        self._guard_snapshot = None
        self._rollbacks = 0
        self._rollbacks_at_progress = 0
        self._ckpt_thread = None
        self._ckpt_error = None
        self._prof = None
        self.profile_summary: Optional[dict] = None
        # The reference overrides the densify interval to the camera count.
        self.interval_densify = len(scene.cameras) or cfg.interval_densify
        self._timestamp = time.strftime("%Y_%m_%d-%H_%M_%S")
        self.last_rendered = None
        self.last_metrics: Dict[str, object] = {}  # the last step's, device tensors
        self.densify_history: List[dict] = []
        self.density_probe = None
        self.probe_history: List[dict] = []  # per refresh: step, samples, live, seconds
        self.eval_cameras: List[Camera] = []
        # regularize_diffusion: the guidance (built at the first refresh) and
        # the real camera set the synthetic views are appended to.
        self._diffusion_guidance = None
        self._diffusion_real_cams: Optional[List[Camera]] = None
        self._last_diag = None  # (intersections, dup_dropped, tile_dropped)
        self._no_shrink_until = 0  # hysteresis after a budget grow
        # Independent binning calls the diagnostics sum over (MeshTrainer:
        # n_tile bands, each binned against its own dup_capacity).
        self._budget_bands = 1
        # pose_opt / app_opt: per-camera tables + Adam moments, bound to the
        # initial camera set by name.
        self.pose_deltas = None
        self.app_params = None
        n = max(len(scene.cameras), 1)
        self._pose_slots = {c.name or f"cam{i}": i for i, c in enumerate(scene.cameras)}
        if cfg.pose_opt:
            self.pose_deltas, self._pose_m, self._pose_v = (
                torch.zeros((n, 6), device=self.device) for _ in range(3))
            self._pose_cnt = torch.zeros((n,), dtype=torch.int32, device=self.device)
        if cfg.app_opt:
            self.app_params, self._app_m, self._app_v = (
                torch.zeros((n, 12), device=self.device) for _ in range(3))
            self._app_cnt = torch.zeros((n,), dtype=torch.int32, device=self.device)

    def restore_pose_state(self, extras: dict) -> None:
        """Resume the pose_opt / app_opt tables from
        ``load_checkpoint_extras(path)``."""
        def t(name, dtype=torch.float32):
            return torch.as_tensor(extras[name], dtype=dtype).to(self.device)

        if self.pose_deltas is not None and "pose_deltas" in extras:
            self.pose_deltas, self._pose_m, self._pose_v = (
                t("pose_deltas"), t("pose_m"), t("pose_v"))
            self._pose_cnt = t("pose_cnt", torch.int32)
        if self.app_params is not None and "app_params" in extras:
            self.app_params, self._app_m, self._app_v = t("app_params"), t("app_m"), t("app_v")
            self._app_cnt = t("app_cnt", torch.int32)

    def _pose_slot(self, camera) -> Optional[int]:
        if self.pose_deltas is None and self.app_params is None:
            return None
        return self._pose_slots.get(camera.name or f"cam{self.scene.cameras.index(camera)}")

    # -- ground truth on the device ------------------------------------------------

    def _device_image(self, camera, w: int, h: int) -> torch.Tensor:
        """The camera's ground truth at (w, h), cached on the device: training
        touches each camera many times, so each frame is uploaded once."""
        key = (camera.name, w, h)
        img = self._image_cache.get(key)
        if img is None:
            with self._decode_lock[camera.name]:
                img = self._image_cache.get(key)
                if img is None:
                    img = torch.as_tensor(camera.get_original_image((w, h)),
                                          dtype=torch.float32).to(self.device)
                    self._image_cache[key] = img
        return img

    def prefetch_images(self, workers: int = 4) -> None:
        """Warm the ground-truth cache on a thread pool (cfg.prefetch_images),
        once: the decodes and uploads overlap the first steps."""
        from concurrent.futures import ThreadPoolExecutor

        cams = list(self.scene.cameras)
        if not cams or self._prefetched:
            return
        self._prefetched = True

        def warm(cam):
            ch, cw = self._c2f_dims(cam)
            self._device_image(cam, cw, ch)
            if (ch, cw) != (cam.height, cam.width):  # full res used later
                self._device_image(cam, cam.width, cam.height)

        pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="img-prefetch")
        self._prefetch_futures = [pool.submit(warm, c) for c in cams]
        pool.shutdown(wait=False)

    # -- coarse-to-fine ---------------------------------------------------------------

    def _c2f_height_quantum(self) -> int:
        """Height snap of reduced resolutions (MeshTrainer: n_tile bands of
        whole tile rows)."""
        return self.cfg.tile_size

    def _c2f_scale(self) -> float:
        cfg = self.cfg
        if not cfg.coarse_to_fine:
            return 1.0
        end = cfg.c2f_end or max(cfg.max_iter // 2, 1)
        if self.step >= end:
            return 1.0
        n_stages = max(1, math.ceil(math.log2(1.0 / cfg.c2f_start_scale)))
        stage_len = max(1, end // n_stages)
        return min(1.0, cfg.c2f_start_scale * (2 ** (self.step // stage_len)))

    def _c2f_dims(self, camera) -> Tuple[int, int]:
        """(h, w) to train at this step: full resolution, or a tile-snapped
        fraction of it during the coarse stages."""
        s = self._c2f_scale()
        if s >= 1.0:
            return camera.height, camera.width
        qh, qw = self._c2f_height_quantum(), self.cfg.tile_size
        return (max(qh, int(camera.height * s) // qh * qh),
                max(qw, int(camera.width * s) // qw * qw))

    @staticmethod
    def _scale_cam_params(cam_params, camera, h: int, w: int):
        """Rescale the pixel-space intrinsics to a reduced resolution (the
        FOV-based projection matrix does not depend on it)."""
        if (h, w) == (camera.height, camera.width):
            return cam_params
        sx, sy = w / camera.width, h / camera.height
        return dataclasses.replace(cam_params, fx=cam_params.fx * sx, fy=cam_params.fy * sy,
                                   cx_off=cam_params.cx_off * sx,
                                   cy_off=cam_params.cy_off * sy)

    # -- hooks of the sharded trainer --------------------------------------------------

    @contextlib.contextmanager
    def _whole_state(self):
        """Hold every splat in ``self.state`` / ``self.opt_state`` for the
        enclosed host pass (MeshTrainer gathers its shards, then shards the
        result again)."""
        yield

    def _invalidate_step_cache(self) -> None:
        """Hook after a config change (a budget retune): the step is built
        from ``self.cfg`` each time here; MeshTrainer drops its built step."""

    def _global_capacity(self) -> int:
        """Slots over every rank (MeshTrainer: the shards together)."""
        return self.state.capacity

    # -- densification ----------------------------------------------------------------

    def _maybe_densify(self) -> None:
        cfg, step = self.cfg, self.step
        if step < cfg.warmup_densify or step > cfg.densify_end:
            return
        every = self.interval_densify
        if cfg.densify_strategy == "mcmc" and cfg.mcmc_refine_every > 0:
            every = cfg.mcmc_refine_every
        if step % every != 0:
            return
        with self._whole_state():
            self._densify()

    def _densify(self) -> None:
        cfg, step = self.cfg, self.step
        cap_before = self.state.capacity
        t0 = time.perf_counter()
        if cfg.densify_strategy == "mcmc":
            # Relocation instead of clone / split / prune: the capacity is
            # the cap, so nothing overflows and nothing grows. The pass ends
            # in a host read of its counts, so the span is its whole time.
            with span("ts.trainer.mcmc_relocate"):
                self.state, self.opt_state, stats = relocate_and_grow(
                    self.state, self.opt_state, cfg, generator=self.generator)
            self.densify_history.append(dict(stats, step=step, overflow=0,
                                             capacity_before=cap_before,
                                             capacity_after=cap_before,
                                             seconds=time.perf_counter() - t0))
            log.debug("mcmc refine step %d: %s", step, self.densify_history[-1])
            return
        cam = self.scene.cameras[0]
        max_dim = max(cam.width, cam.height)
        args = (self.interval_densify, max_dim, cfg)
        self.state, self.opt_state, stats = densify_and_prune(
            self.state, self.opt_state, *args, generator=self.generator,
            keep_on_overflow=True)
        overflow = stats["dropped"]
        if overflow > 0:
            # Not enough free slots: grow capacity and redo the pass on the
            # grown tensors, so nothing is lost.
            new_cap = max(2 * cap_before, cap_before + 2 * overflow)
            log.info("densify overflow (%d dropped): growing capacity %d -> %d",
                     overflow, cap_before, new_cap)
            self.state = grow_capacity(self.state, new_cap)
            self.opt_state = grow_opt_state(self.opt_state, self.state)
            self.state, self.opt_state, stats = densify_and_prune(
                self.state, self.opt_state, *args, generator=self.generator)
        # The pass ends in host reads of its counts, so this is its time.
        self.densify_history.append(dict(stats, step=step, overflow=overflow,
                                         capacity_before=cap_before,
                                         capacity_after=self.state.capacity,
                                         seconds=time.perf_counter() - t0))
        log.debug("densify step %d: %s", step, self.densify_history[-1])

    def _maybe_compact(self) -> None:
        """Periodic capacity reclamation (cfg.compact_interval), after densify
        so freshly freed slots are reclaimed in the same pass."""
        cfg = self.cfg
        if cfg.compact_interval <= 0 or self.step % cfg.compact_interval != 0:
            return
        if cfg.densify_strategy == "mcmc":
            return  # the capacity is MCMC's growth ceiling: never shrunk
        with self._whole_state():
            old_cap = self.state.capacity
            self.state, self.opt_state, did = compact_state(self.state, self.opt_state,
                                                            margin=cfg.compact_margin)
            if did:
                log.info("compacted capacity %d -> %d (%d live)", old_cap,
                         self.state.capacity, int(self.state.num_live()))
                # Compaction permutes the rows: the probe's KNN indices would
                # point at other splats, so it is rebuilt at the next step.
                self.density_probe = None

    def _maybe_refresh_density_probe(self) -> None:
        """At the window start, prune sigmoid(opacity) < 0.5; rebuild the
        probe at the start, on ``step % cfg.interval_densify == 1`` (the raw
        flag, not the camera-count interval of the densify pass) and when
        it was dropped."""
        cfg, step = self.cfg, self.step
        if not (cfg.regularize_density
                and cfg.regularize_density_start <= step < cfg.regularize_density_end):
            return
        start = step == cfg.regularize_density_start
        refresh = start or step % max(cfg.interval_densify, 1) == 1 or self.density_probe is None
        if not refresh:
            return
        with self._whole_state():
            if start:
                faint = torch.sigmoid(self.state.params.opacities[:, 0]) < 0.5
                self.state, self.opt_state = prune_by_mask(self.state, self.opt_state, faint)
            timings: Dict[str, float] = {}
            self.density_probe = make_density_probe(
                self.state.params, self.state.alive, num_samples=cfg.density_samples,
                generator=self.generator, timings=timings)
            self.probe_history.append(dict(timings, step=step, samples=cfg.density_samples,
                                           live=int(self.state.num_live())))

    def _maybe_refresh_diffusion_views(self) -> None:
        """On cadence inside the window, swap freshly refined synthetic views
        into the scene; once the window has closed, put the real set back
        (the last views must not keep training the model toward stale
        frames). Cached frames of replaced synthetic cameras are dropped:
        the names repeat across refreshes."""
        cfg, step = self.cfg, self.step
        if not cfg.regularize_diffusion:
            return
        if not cfg.regularize_diffusion_start <= step < cfg.regularize_diffusion_end:
            if (step >= cfg.regularize_diffusion_end and self._diffusion_real_cams is not None
                    and len(self.scene.cameras) != len(self._diffusion_real_cams)):
                self._drop_synthetic_frames()
                self.scene.cameras = self._diffusion_real_cams
                log.info("diffusion window ended: synthetic views removed")
            return
        first = step == cfg.regularize_diffusion_start or self._diffusion_guidance is None
        if not first and step % cfg.interval_diffusion != 0:
            return
        from .regularizers.diffusion_guidance import DiffusionGuidance

        if self._diffusion_guidance is None:
            self._diffusion_guidance = DiffusionGuidance(cfg, rng_seed=cfg.seed,
                                                         device=self.device)
            self._diffusion_real_cams = list(self.scene.cameras)
        synth = self._diffusion_guidance.refresh(self, self._diffusion_real_cams)
        self._drop_synthetic_frames()
        self.scene.cameras = self._diffusion_real_cams + synth
        log.info("diffusion guidance: %d synthetic views refreshed at step %d", len(synth), step)

    def _drop_synthetic_frames(self) -> None:
        """Evict the cached frames (every resolution) of the scene's
        synthetic cameras."""
        stale = {c.name for c in self.scene.cameras
                 if c.name and c.name.startswith("diffusion_")}
        for k in [k for k in self._image_cache if k[0] in stale]:
            del self._image_cache[k]

    # -- main loop --------------------------------------------------------------------

    def train_step(self) -> None:
        """One training iteration, under the trainer's lock."""
        with self._lock:
            self._train_step()

    def _train_step(self) -> None:
        with span("ts.trainer.step"):
            cfg = self.cfg
            self.step += 1
            self._maybe_refresh_density_probe()
            self._maybe_refresh_diffusion_views()
            with span("ts.trainer.camera"):
                # 0-based sample index: step was just incremented.
                camera = self.scene.get_random_camera(self.step - 1)
                h, w = self._c2f_dims(camera)
                gt = self._device_image(camera, w, h)
                est_depth = None
                if cfg.regularize_depth and camera.estimated_depth is not None:
                    est_depth = torch.as_tensor(camera.estimated_depth,
                                                dtype=torch.float32).to(self.device)
                    if est_depth.shape != (h, w):  # coarse-to-fine stage
                        est_depth = torch.nn.functional.interpolate(
                            est_depth[None, None], size=(h, w), mode="bilinear",
                            align_corners=False, antialias=True)[0, 0]
                slot = self._pose_slot(camera)
                pose_delta = self.pose_deltas[slot] if cfg.pose_opt and slot is not None else None
                app_param = self.app_params[slot] if cfg.app_opt and slot is not None else None
                cam_params = self._scale_cam_params(camera.params(self.device), camera, h, w)
            out = make_train_step(cfg, h, w)(
                self.state, self.opt_state, cam_params, gt, est_depth, self.step,
                generator=self.generator, pose_delta=pose_delta, app_params=app_param,
                density_probe=self.density_probe)
            with span("ts.trainer.post_step"):
                self.state, self.opt_state = out.state, out.opt_state
                self.last_rendered = out.rendered
                self.last_metrics = dict(out.metrics)
                if slot is not None and "pose_grad" in out.metrics:
                    g = out.metrics.pop("pose_grad")
                    _adam_row(self.pose_deltas, self._pose_m, self._pose_v, self._pose_cnt,
                              slot, g, cfg.lr_pose)
                if slot is not None and "app_grad" in out.metrics:
                    g = out.metrics.pop("app_grad")
                    _adam_row(self.app_params, self._app_m, self._app_v, self._app_cnt, slot,
                              g, cfg.lr_app)
                self._post_step(out)

    def _post_step(self, out) -> None:
        """Metrics, densify, compaction, budget retune, opacity reset, NaN
        guard and checkpoint, in the JAX trainer's order."""
        cfg = self.cfg
        self.metrics.update(self.step, out.metrics)
        if "n_intersections" in out.metrics:
            self._last_diag = (out.metrics["n_intersections"], out.metrics["n_dup_dropped"],
                               out.metrics["n_tile_dropped"])
        self._maybe_densify()
        self._maybe_compact()
        with span("ts.trainer.retune"):
            self._maybe_retune_budgets()
        if (cfg.interval_opacity_reset > 0 and self.step % cfg.interval_opacity_reset == 0
                and self.step <= cfg.densify_end
                and cfg.densify_strategy != "mcmc"):  # MCMC regulates opacity itself
            self.state, self.opt_state = reset_opacities(self.state, cfg.epsilon_alpha,
                                                         opt_state=self.opt_state)
        # Host syncs are cadenced, never per step.
        if self.step % self.metrics.num_cameras == 0:
            with span("ts.trainer.log"):
                self.metrics.log(self.step, extra=f"N: {int(out.metrics['num_live'])}")
        with span("ts.trainer.nan_guard"):
            self._nan_guard(out.metrics["loss"])
        self._maybe_checkpoint()

    def _checkpoint_extras(self) -> Optional[dict]:
        extras = {}
        if self.pose_deltas is not None:
            extras.update(pose_deltas=self.pose_deltas, pose_m=self._pose_m,
                          pose_v=self._pose_v, pose_cnt=self._pose_cnt)
        if self.app_params is not None:
            extras.update(app_params=self.app_params, app_m=self._app_m, app_v=self._app_v,
                          app_cnt=self._app_cnt)
        return extras or None

    def _maybe_checkpoint(self) -> None:
        cfg = self.cfg
        if not (cfg.save_checkpoints and self.step % cfg.checkpoint_interval == 0):
            return
        from .io.checkpoint import save_checkpoint

        path = f"{cfg.checkpoint_dir}/{self._timestamp}-{self.step}.npz"
        extras = self._checkpoint_extras()
        if not cfg.async_checkpoint:
            save_checkpoint(path, self.state, self.opt_state, self.step,
                            self.generator.get_state(), extras=extras)
            log.info("saved checkpoint %s", path)
            return
        # A device copy goes to a writer thread (the next steps update the
        # live tensors in place). At most one write is in flight: joining
        # the previous writer first bounds memory at one extra copy.
        self.finish_checkpoints()
        snap = self._snapshot()
        extras = {k: v.clone() for k, v in (extras or {}).items()} or None

        def work(snap=snap, path=path, extras=extras):
            try:
                state, opt_state = self._restore(snap)
                save_checkpoint(path, state, opt_state, snap["step"], snap["rng"],
                                extras=extras)
                log.info("saved checkpoint %s (async)", path)
            except BaseException as e:  # surfaced at the next join
                self._ckpt_error = e

        self._ckpt_thread = threading.Thread(target=work, daemon=True,
                                             name=f"ckpt-{self.step}")
        self._ckpt_thread.start()

    def finish_checkpoints(self) -> None:
        """Block until an in-flight async checkpoint has landed; re-raise a
        failed writer's exception."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        err, self._ckpt_error = self._ckpt_error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    # -- failure detection / rollback -------------------------------------------------

    def _snapshot(self) -> dict:
        """Copies of the state, the Adam moments and count, the step and the
        generator state. Copies, not references: the optimizer updates the
        live tensors in place."""
        mu, nu, count = self.opt_state.moments()
        s = self.state
        return {
            "params": {name: t.detach().clone() for name, t in s.params.fields()},
            "alive": s.alive.clone(), "accum": s.means_grad_accum.clone(),
            "deg": s.active_sh_degree.clone(),
            "mu": {k: v.clone() for k, v in mu.items()},
            "nu": {k: v.clone() for k, v in nu.items()},
            "count": count, "step": self.step, "rng": self.generator.get_state(),
        }

    def _restore(self, snap: dict):
        """(state, optimizer) rebuilt from a snapshot, on new tensors (the
        snapshot stays intact for another rollback)."""
        params = GaussianParams(**{k: v.clone() for k, v in snap["params"].items()})
        state = GaussianState(params=params, alive=snap["alive"].clone(),
                              means_grad_accum=snap["accum"].clone(),
                              active_sh_degree=snap["deg"].clone())
        return state, optimizer_with_moments(self.cfg, params, snap["mu"], snap["nu"],
                                             snap["count"])

    def _nan_guard(self, loss) -> None:
        """Divergence detection and rollback: every ``nan_guard_interval``
        steps a snapshot; a non-finite loss restores it and reseeds the
        generator so the replay draws other numbers. The loss is read on a
        cadence (always on snapshot steps), not every step."""
        interval = self.cfg.nan_guard_interval
        if interval <= 0:
            return
        check_every = max(1, min(interval // 2, self.metrics.num_cameras))
        if self.step % check_every != 0 and self.step % interval != 0:
            return
        if not math.isfinite(float(loss)):
            snap = self._guard_snapshot
            if snap is None:
                raise FloatingPointError(f"non-finite loss at step {self.step} with no snapshot")
            if self._rollbacks - self._rollbacks_at_progress >= 3:
                raise FloatingPointError(
                    f"non-finite loss at step {self.step}: 3 consecutive rollbacks to step "
                    f"{snap['step']} made no progress")
            log.warning("non-finite loss at step %d: rolling back to step %d", self.step,
                        snap["step"])
            self.state, self.opt_state = self._restore(snap)
            self.step = snap["step"]
            self.generator.set_state(snap["rng"])
            self.generator.manual_seed(
                int(torch.randint(0, 2**62, (1,), generator=self.generator,
                                  device=self.device)) ^ (self.step + 1))
            self._rollbacks += 1
            return
        if self.step % interval == 0:
            # A new snapshot point with a finite loss is progress past the
            # last rollback target: re-arm the consecutive-rollback cap.
            self._rollbacks_at_progress = self._rollbacks
            self._guard_snapshot = self._snapshot()

    def run(self, max_iter: Optional[int] = None) -> None:
        end = max_iter if max_iter is not None else self.cfg.max_iter
        if self.cfg.prefetch_images and not dist.is_initialized():
            self.prefetch_images()
        try:
            while self.step < end:
                self._maybe_profile_window()
                self.train_step()
                self._maybe_eval()
        finally:
            # Land (or surface) an in-flight async checkpoint even when
            # training raises: the one before a crash is the one needed.
            self.finish_checkpoints()

    async def run_async(self, max_iter: Optional[int] = None) -> None:
        """``run`` beside an event loop (the live viewer's): each step runs
        in an executor thread, so the loop keeps serving sockets while the
        device works, and the loop is yielded after each step."""
        import asyncio

        loop = asyncio.get_running_loop()
        end = max_iter if max_iter is not None else self.cfg.max_iter
        if self.cfg.prefetch_images and not dist.is_initialized():
            self.prefetch_images()
        try:
            while self.step < end:
                self._maybe_profile_window()
                await loop.run_in_executor(None, self.train_step)
                self._maybe_eval()
                await asyncio.sleep(0)
        finally:
            self.finish_checkpoints()

    def _maybe_profile_window(self) -> None:
        """cfg.profile_steps N: trace steps [profile_start, profile_start + N)
        with ``torch.profiler`` (CUDA activity on a CUDA device), then print
        the top ops and the share of the window in which a kernel ran, and
        write a Chrome trace to ``<cfg.profile_dir>/<run timestamp>/trace.json``
        (the checkpoints' timestamp)."""
        cfg = self.cfg
        if cfg.profile_steps <= 0:
            return
        if self.step == cfg.profile_start and self._prof is None:
            self._prof = torch.profiler.profile(activities=profiling.activities(self.device))
            self._prof.start()
        elif self._prof is not None and self.step >= cfg.profile_start + cfg.profile_steps:
            synchronize(self.device)
            prof, self._prof = self._prof, None
            prof.stop()
            logdir = os.path.join(cfg.profile_dir, self._timestamp)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            table, share = profiling.print_window(
                prof, self.device, f"profile window ({cfg.profile_steps} steps)")
            self.profile_summary = {"steps": cfg.profile_steps, "table": table,
                                    "kernel_busy_share": share}

    def _maybe_eval(self) -> None:
        if (self.cfg.eval_interval and self.eval_cameras
                and self.step % self.cfg.eval_interval == 0):
            self.evaluate()

    # -- binning budget retune ----------------------------------------------------------

    def _maybe_retune_budgets(self) -> None:
        """Once per epoch, retune the binning budgets to ~2x the observed
        intersections: grow at once when entries were dropped, shrink when
        under 25% used (not within 3 epochs of a grow)."""
        if self._last_diag is None or self.step % self.interval_densify != 0:
            return
        inter, dup_dropped, tile_dropped = (int(x) for x in self._last_diag)
        self._last_diag = None
        # A single band can hold every intersection, so growth uses the
        # global count; shrinking uses the per-band mean (a band 4x above
        # the mean still fits after the 2x headroom).
        inter_band = -(-inter // max(self._budget_bands, 1))
        n = self._global_capacity()
        current = self.cfg.dup_capacity or 8 * n
        changes = {}
        if dup_dropped > 0:
            changes["dup_capacity"] = max(2 * (inter + dup_dropped), current * 2)
        elif (inter > 0 and inter_band < current // 4 and current > 2 * n
              and self.step >= self._no_shrink_until):
            changes["dup_capacity"] = max(2 * inter_band, 2 * n)
        if tile_dropped > 0:
            cam = self.scene.cameras[0]
            num_tiles = max(((cam.width + 15) // 16) * ((cam.height + 15) // 16), 1)
            eff = self.cfg.max_per_tile or min(
                4096, max((self.cfg.dup_capacity or 8 * n) // num_tiles, 256))
            changes["max_per_tile"] = min(2 * eff, 16384)
        if not changes:
            return
        if "dup_capacity" in changes:
            # Rounded up on a grid of 1/8 of the value's magnitude, as the
            # JAX trainer does (it reuses compiled steps across runs).
            v = int(changes["dup_capacity"])
            grid = max(128, 1 << max(v.bit_length() - 3, 7))
            changes["dup_capacity"] = -(-v // grid) * grid
        if changes.get("dup_capacity", current) > current or "max_per_tile" in changes:
            self._no_shrink_until = self.step + 3 * self.interval_densify
        log.info("retuning budgets %s (intersections %d, dup_dropped %d, tile_dropped %d)",
                 changes, inter, dup_dropped, tile_dropped)
        self.cfg = dataclasses.replace(self.cfg, **changes)
        self._invalidate_step_cache()

    # -- evaluation and rendering -------------------------------------------------------

    def evaluate(self, cameras: Optional[List[Camera]] = None) -> Dict[str, float]:
        """Mean PSNR / SSIM over held-out cameras, rendered over the fixed
        background."""
        cams = cameras if cameras is not None else self.eval_cameras
        if not cams:
            return {}
        bg = fixed_background(self.cfg, self.device)
        psnrs, ssims = [], []
        for cam in cams:
            rgb, _ = self.render_camera(cam, background=bg)
            gt = torch.as_tensor(cam.get_original_image((cam.width, cam.height)),
                                 dtype=torch.float32).to(self.device)
            psnrs.append(psnr(rgb, gt))
            ssims.append(ssim(rgb, gt))
        out = {"eval_psnr": float(torch.stack(psnrs).mean()),
               "eval_ssim": float(torch.stack(ssims).mean()),
               "num_eval_cameras": len(cams)}
        log.info("eval @ step %d: PSNR %.2f SSIM %.4f (%d cams)", self.step,
                 out["eval_psnr"], out["eval_ssim"], len(cams))
        return out

    def render_camera(self, camera: Camera, dims=None, background=None):
        """Inference render of ``camera`` (refined pose under pose_opt) at
        ``dims`` (w, h), default its own: (rgb, extras). Safe to call from a
        viewer thread while another thread trains (the trainer's lock)."""
        with span("ts.trainer.render_camera"):
            w, h = dims if dims is not None else (camera.width, camera.height)
            bg = background if background is not None else torch.zeros(3, device=self.device)
            with self._lock, torch.no_grad():
                state, cfg = self.state, self.cfg  # one consistent version
                with span("ts.trainer.camera"):
                    cam_params = camera.params(self.device)
                    slot = self._pose_slot(camera)
                    if slot is not None and self.pose_deltas is not None:
                        cam_params = apply_pose_delta(cam_params, self.pose_deltas[slot])
                return render(state.params, state.alive, cam_params, h, w,
                              state.active_sh_degree, bg, rasterizer=cfg.rasterizer,
                              viewdirs_mode=cfg.viewdirs_mode, tile_size=cfg.tile_size,
                              dup_capacity=cfg.dup_capacity, max_per_tile=cfg.max_per_tile,
                              span_capacity=cfg.span_capacity, grad_reduce=cfg.grad_reduce,
                              tile_x=cfg.tile_x, antialiased=cfg.antialiased)
