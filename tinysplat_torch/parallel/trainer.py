"""Multi-device trainer: the host loop over the sharded train step.

Torch port of ``tinysplat_tpu.parallel.trainer``. Every rank runs this loop
in lockstep, with the same cameras, the same generator state and the same
host decisions:

- each step takes one camera per data group (the 0-based sample indices
  (step - 1) * n_data + i, so one camera a step samples as the one-device
  trainer does), data group d the d-th of them; a rank stages only its
  band of the ground truth;
- the splat state and the Adam moments stay sharded between steps
  (``shard_state``), and the host passes that need every splat (densify,
  capacity growth, compaction, the density-probe prune and refresh) run on
  the gathered state, identically on every rank, then shard it again;
- the density probe keeps each tile rank's block of the sample points,
  trimmed to a multiple of n_tile;
- the checkpoint is sharded (``io.checkpoint.save_checkpoint_sharded``);
- ``render_camera`` renders through ``make_sharded_render`` (bands over
  every rank), so evaluation and frames are collective calls.

The per-step host logic (NaN guard, opacity reset, budget retune, eval,
checkpoints) is the base ``Trainer``'s (``_post_step``), run unchanged.
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..cameras import apply_pose_delta
from ..config import Config
from ..models.gaussians import GaussianState
from ..scene import Scene
from ..train_loop import Trainer, _adam_row
from .sharding import (
    gather_state,
    host_to_global,
    make_mesh,
    shard_state,
    world_size,
)
from .train_step import band_major_rows, make_sharded_render, make_sharded_train_step

log = logging.getLogger(__name__)


def _local_rank(rank: Optional[int] = None) -> int:
    """This process's rank among the ranks of its host: LOCAL_RANK (set by
    torchrun and ``parallel.local.run``), else ``rank``, else the global
    rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The device of this process (or of ``rank`` on a host without
    LOCAL_RANK): ``cuda:(local rank % device_count)`` for CUDA, else
    ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank asked for, but torch sees no CUDA device; pass "
                           "device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())


def init_distributed(init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None, device="cuda") -> torch.device:
    """Join the process group (once; a no-op when it exists) and return
    this rank's device.

    ``init_method`` is a ``tcp://host:port`` or ``file://`` address; with
    none, the ``torchrun`` environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) is read. The backend is gloo on the CPU and NCCL on CUDA,
    unless the ranks of this host outnumber its cards: LOCAL_WORLD_SIZE
    (set by torchrun and ``parallel.local.run``) > device_count. NCCL
    refuses two ranks on one card, so those ranks run gloo and the
    collectives stage CUDA tensors through pinned host memory. Without
    LOCAL_WORLD_SIZE every rank is taken to own a card, whatever the
    global world size (a multi-host world has more ranks than one host has
    cards)."""
    if dist.is_initialized():
        return rank_device(device)
    kw = {}
    if init_method is None:
        init_method = "env://"
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group address: pass a coordinator address "
                               f"or run under torchrun (missing {missing})")
    else:
        kw = dict(rank=rank if rank is not None else 0,
                  world_size=world_size if world_size is not None else 1)
    backend = "gloo"
    dev = rank_device(device, kw.get("rank", int(os.environ.get("RANK", 0))))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 0))
        cards = torch.cuda.device_count()
        if local > cards:
            log.info("%d local ranks share %d CUDA device(s): gloo, with the collectives "
                     "staged through pinned host memory", local, cards)
        else:
            backend = "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, **kw)
    return dev


class MeshTrainer(Trainer):
    """Trainer over a ('data', 'tile') mesh of ranks.

    Every rank constructs it with the same full ``state`` (and optimizer,
    if resuming) on its own device, and keeps its shard. All cameras must
    share one image shape, with H divisible by n_tile * tile_size.
    """

    def __init__(self, cfg: Config, scene: Scene, state: GaussianState, opt_state=None,
                 start_step: int = 0, rng_state: Optional[torch.Tensor] = None, mesh=None):
        if cfg.regularize_diffusion:
            # Synthetic views are square at the pipeline's resolution, and
            # the mesh step needs one image shape.
            raise ValueError("regularize_diffusion runs on the single-device trainer only "
                             "(train_loop.Trainer); MeshTrainer does not take it")
        if mesh is None:  # --mesh-tile 0 or 1: every rank left over
            mesh = make_mesh(max(cfg.mesh_splat, 1), cfg.mesh_tile if cfg.mesh_tile > 1 else 0)
        self.mesh = mesh
        super().__init__(cfg, scene, state, opt_state, start_step, rng_state)
        self.n_data, self.n_tile = self.mesh.data, self.mesh.tile
        self.batch = self.n_data  # cameras a step: one per data group
        self._budget_bands = self.n_tile  # per-band binning budgets
        shapes = {(c.height, c.width) for c in scene.cameras}
        if len(shapes) != 1:
            raise ValueError(f"MeshTrainer needs a single camera image shape, got {shapes}")
        self.h, self.w = shapes.pop()
        self.state, self.opt_state = shard_state(self.mesh, self.state, self.opt_state)
        self._sharded_step = None
        self._sharded_step_key = None
        self._warned_no_depth = False
        if world_size() > 1:
            # Checkpoint paths embed the run's timestamp: every rank takes
            # rank 0's, so all shards land in one directory.
            ts = [self._timestamp]
            dist.broadcast_object_list(ts, src=0)
            self._timestamp = ts[0]

    # -- hooks of the base loop ------------------------------------------------

    @contextlib.contextmanager
    def _whole_state(self):
        self.state, self.opt_state = gather_state(self.mesh, self.state, self.opt_state)
        try:
            yield
        finally:
            self.state, self.opt_state = shard_state(self.mesh, self.state, self.opt_state)

    def _invalidate_step_cache(self) -> None:
        self._sharded_step = None

    def _global_capacity(self) -> int:
        return self.state.capacity * self.mesh.size

    def _c2f_height_quantum(self) -> int:
        # H splits into n_tile bands of whole tile rows.
        return self.n_tile * self.cfg.tile_size

    def _use_depth(self) -> bool:
        """The depth term is wired in only when every camera has a map: a
        batch cannot skip it per camera as the one-device step does."""
        if not self.cfg.regularize_depth:
            return False
        have = all(c.estimated_depth is not None for c in self.scene.cameras)
        if not have and not self._warned_no_depth:
            log.warning("--regularize-depth asked for, but not every camera has an estimated "
                        "depth map; the depth term is off on the mesh trainer (run the "
                        "DepthEstimator first)")
            self._warned_no_depth = True
        return have

    def _get_sharded_step(self, h: int, w: int):
        key = (self.density_probe is not None, self._use_depth(), h, w)
        if self._sharded_step is None or self._sharded_step_key != key:
            self._sharded_step = make_sharded_train_step(
                self.cfg, h, w, self.batch, self.mesh, use_depth=key[1], use_density=key[0])
            self._sharded_step_key = key
        return self._sharded_step

    def _interleave_active(self) -> bool:
        return bool(self.cfg.band_interleave) and self.n_tile > 1

    def _band(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's band of a whole (h, ...) host frame, on the device:
        the rows put band after band, then the rank's 'tile' block."""
        rows = band_major_rows(full.shape[0], self.n_tile, self.cfg.tile_size,
                               self._interleave_active())
        return host_to_global(self.mesh, ("tile",), full[rows], self.device)

    def _device_image(self, camera, w: int, h: int) -> torch.Tensor:
        """This rank's band of the camera's ground truth at (w, h), cached
        on the device (only the band is uploaded)."""
        key = (camera.name, w, h)
        img = self._image_cache.get(key)
        if img is None:
            with self._decode_lock[camera.name]:
                img = self._image_cache.get(key)
                if img is None:
                    img = self._band(torch.as_tensor(camera.get_original_image((w, h)),
                                                     dtype=torch.float32))
                    self._image_cache[key] = img
        return img

    def _band_depth(self, camera, w: int, h: int) -> torch.Tensor:
        est = torch.as_tensor(camera.estimated_depth, dtype=torch.float32).to(self.device)
        if est.shape != (h, w):  # coarse-to-fine stage
            est = torch.nn.functional.interpolate(
                est[None, None], size=(h, w), mode="bilinear", align_corners=False,
                antialias=True)[0, 0]
        return self._band(est)

    def _maybe_refresh_density_probe(self) -> None:
        # The base pass builds the whole probe; this tile rank keeps its
        # block of the points (the count trimmed to a multiple of n_tile).
        before = self.density_probe
        super()._maybe_refresh_density_probe()
        p = self.density_probe
        if p is not None and p is not before:
            n = p.points.shape[0] // self.n_tile
            t = self.mesh.coords[1]
            self.density_probe = type(p)(*(x[t * n:(t + 1) * n] for x in p))

    # -- main loop -------------------------------------------------------------

    def _train_step(self) -> None:
        cfg = self.cfg
        self.step += 1
        self._maybe_refresh_density_probe()
        bl = self.batch // self.n_data
        cams: List = [self.scene.get_random_camera((self.step - 1) * self.batch + i)
                      for i in range(self.batch)]
        h, w = self._c2f_dims(cams[0])  # full resolution unless coarse_to_fine
        first = self.mesh.coords[0] * bl
        local = cams[first:first + bl]  # this data group's cameras
        gt = torch.stack([self._device_image(c, w, h) for c in local])
        step_fn = self._get_sharded_step(h, w)
        est = None
        if self._sharded_step_key[1]:
            est = torch.stack([self._band_depth(c, w, h) for c in local])
        slots = [self._pose_slot(c) for c in cams]
        kw = {}
        for name, table, k in (("pose_deltas", self.pose_deltas, 6),
                               ("app_params", self.app_params, 12)):
            if table is not None:
                kw[name] = torch.stack([table[s] if s is not None else table.new_zeros(k)
                                        for s in slots[first:first + bl]])
        cam_params = [self._scale_cam_params(c.params(self.device), c, h, w) for c in local]
        out = step_fn(self.state, self.opt_state, cam_params, gt, est, self.step,
                      generator=self.generator, density_probe=self.density_probe, **kw)
        self.state, self.opt_state = out.state, out.opt_state
        self.last_metrics = dict(out.metrics)
        for name, table, moments in (("pose_grad", self.pose_deltas, "_pose"),
                                     ("app_grad", self.app_params, "_app")):
            if name not in out.metrics:
                continue
            g = out.metrics.pop(name)  # (B, k)
            # A camera twice in one batch sums its gradients into one Adam
            # step instead of advancing the moments once per occurrence.
            acc: dict = {}
            for b, s in enumerate(slots):
                if s is not None:
                    acc[s] = acc[s] + g[b] if s in acc else g[b]
            lr = cfg.lr_pose if name == "pose_grad" else cfg.lr_app
            for s, gs in acc.items():
                _adam_row(table, getattr(self, moments + "_m"), getattr(self, moments + "_v"),
                          getattr(self, moments + "_cnt"), s, gs, lr)
        self._post_step(out)

    def _maybe_checkpoint(self) -> None:
        cfg = self.cfg
        if not (cfg.save_checkpoints and self.step % cfg.checkpoint_interval == 0):
            return
        from ..io.checkpoint import save_checkpoint_sharded

        # Every rank writes its own shard; rank 0 adds the manifest. Restore
        # with restore_checkpoint_sharded into any mesh, or one rank.
        path = f"{cfg.checkpoint_dir}/{self._timestamp}-{self.step}.ckpt"
        save_checkpoint_sharded(path, self.state, self.opt_state, self.step,
                                self.generator.get_state(), extras=self._checkpoint_extras(),
                                mesh=self.mesh)
        if self.mesh.rank == 0:
            log.info("saved sharded checkpoint %s", path)

    # -- rendering for eval / viewer -------------------------------------------

    def render_camera(self, camera, dims=None, background=None):
        """Sharded inference render: pixel rows over every rank, splats
        sharded (``make_sharded_render``), the whole frame on every rank.
        The one-device path serves a height that does not split over the
        ranks only when there is one rank."""
        w, h = dims if dims is not None else (camera.width, camera.height)
        n = self.mesh.size
        if h % n:
            if n > 1:
                raise ValueError(f"a sharded render needs the height divisible by the rank "
                                 f"count ({h} % {n} != 0)")
            return super().render_camera(camera, dims, background)
        bg = background if background is not None else torch.zeros(3, device=self.device)
        with self._lock:
            state, cfg = self.state, self.cfg
            fn = make_sharded_render(cfg, h, w, self.mesh)
            cam_params = camera.params(self.device)
            slot = self._pose_slot(camera)
            if slot is not None and self.pose_deltas is not None:
                cam_params = apply_pose_delta(cam_params, self.pose_deltas[slot])
            rgb, depth, alpha = fn(state.params, state.alive, state.active_sh_degree,
                                   cam_params, bg)
        return rgb, {"depth": depth, "alpha": alpha}
