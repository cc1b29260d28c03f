"""A served frame's render, replayed from one captured CUDA graph.

``Trainer.render_camera`` renders through a :class:`FrameGraph`. A frame's
render on the card is a chain of small launches (S1, the depth sort, B1-B4
and their scans, K1's table and work order, K1, untile), each of which costs
the host more than the card; a CUDA graph of the chain is one launch.

- The camera: one packed upload a frame. The view and projection matrices,
  the camera centre, the intrinsics and the background go as ``UPLOAD``
  float32 values from pinned host memory to a device buffer that the graph
  reads, with one asynchronous copy and no host sync (``Camera.params``
  makes seven blocking uploads). A background already on the device is
  copied in there. The pose delta of ``pose_opt`` and the full projection
  (projmat @ viewmat, the product ``render`` takes of ``Camera.params``,
  bit for bit) are computed into the buffer too, outside the capture: a
  cuBLAS call inside it would leave a workspace allocated on the capture
  stream.
- The key: what the captured pointers and shapes depend on, namely (w, h),
  each state leaf's pointer, shape, dtype and stride, and the ``Config``
  fields ``render`` takes. It holds no tensor, so a replaced state is freed
  as before; the camera and the background are not part of it.
- A key is captured when it comes on two frames in a row (a one-off render
  pays no capture) and replayed while it holds. A new key drops the graph
  and its private memory pool. CPU tensors, grad mode and any rasterizer
  but 'cuda' run the render eagerly and unchanged, and so does a key's
  first frame.
- A replayed frame returns clones of the graph's outputs, so a frame that a
  caller keeps is never overwritten by the next replay.
- A replay adds to ``_build.launches`` the launches its capture counted (the
  capture itself runs nothing). ``counts`` counts frames by path:
  ``captures``, ``replays`` (a capture's frame is replayed too) and
  ``eager``. Spans ``ts.render.graph_capture`` and ``ts.render.graph_replay``
  enclose each capture and each replay.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import numpy as np
import torch

from .cameras import Camera, CameraParams, apply_pose_delta
from .ops import _build
from .render import resolve_rasterizer
from .utils.profiling import span

# The Config fields that ``render`` takes, under the same names: what
# ``render_camera``'s draw passes and what a frame's key holds.
RENDER_FIELDS = ("rasterizer", "viewdirs_mode", "tile_size", "dup_capacity", "max_per_tile",
                 "span_capacity", "grad_reduce", "tile_x", "antialiased")
# The device buffer, in float32: viewmat, projmat, cam_pos, fx, fy, cx_off,
# cy_off and the background are uploaded (the first UPLOAD values); the full
# projection is computed after them.
VIEW, PROJ, POS, FX, FY, CX, CY, BG, FULL = (
    slice(0, 16), slice(16, 32), slice(32, 35), 35, 36, 37, 38, slice(39, 42), slice(42, 58))
UPLOAD, BUFFER = 42, 58


@dataclasses.dataclass(frozen=True)
class FrameCamera(CameraParams):
    """``CameraParams`` with its full projection already computed."""

    full: Optional[torch.Tensor] = None

    @property
    def full_projmat(self) -> torch.Tensor:
        return self.full


def frame_key(state, cfg, w: int, h: int) -> tuple:
    """What a captured frame's pointers and shapes depend on; no tensor."""
    leaves = [t for _, t in state.params.fields()] + [state.alive, state.active_sh_degree]
    return ((w, h), tuple((t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)
                          for t in leaves),
            tuple(getattr(cfg, f) for f in RENDER_FIELDS))


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _capture(fn, device):
    """(graph, ``fn()``'s outputs): ``fn``'s work on ``device`` captured into
    a CUDA graph, on a side stream of that device. A thread blocked on the
    trainer's lock, or busy elsewhere on the card, cannot invalidate the
    capture (thread-local capture mode)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(
            graph, stream=torch.cuda.Stream(device), capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def _cloned(x):
    """``x`` with each tensor in it cloned (through tuples and dicts)."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_cloned(v) for v in x)
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    return x


class FrameGraph:
    """One trainer's inference frames: at most one captured graph, replayed
    while its key holds (see the module doc)."""

    def __init__(self):
        self.counts: Counter = Counter()
        self._buffer: Optional[torch.Tensor] = None
        self._views = None  # (FrameCamera, background): views of the buffer
        self._graph = None
        self._out = None  # the graph's static (rgb, extras)
        self._launched: Counter = Counter()  # launches the capture counted
        self._key = None  # the captured frame's
        self._last = None  # the last frame's

    def render(self, draw, state, cfg, camera: Camera, w: int, h: int,
               background: Optional[torch.Tensor] = None,
               pose_delta: Optional[torch.Tensor] = None):
        """``camera`` at (w, h) over ``background`` (black if None), its view
        moved by ``pose_delta`` if given, drawn by ``draw(CameraParams,
        background)``: ``state``'s render under ``cfg`` at (w, h), which
        reads nothing else. Returns draw's (rgb, extras), the caller's to
        keep."""
        dev = state.alive.device
        if (not _on_card(state.alive) or torch.is_grad_enabled()
                or resolve_rasterizer(cfg.rasterizer) != "cuda"):
            self.counts["eager"] += 1
            self._last = None
            with span("ts.trainer.camera"):
                cam = camera.params(dev)
                if pose_delta is not None:
                    cam = apply_pose_delta(cam, pose_delta)
            bg = background if background is not None else torch.zeros(3, device=dev)
            return draw(cam, bg)
        with span("ts.trainer.camera"):
            cam, bg = self._upload(camera, background, pose_delta, dev)
        key = frame_key(state, cfg, w, h)
        if key != self._key:
            self._drop()
            if key != self._last:
                self._last = key
                self.counts["eager"] += 1
                return draw(cam, bg)
            with span("ts.render.graph_capture"):
                before = _build.launches.copy()
                self._graph, self._out = _capture(lambda: draw(cam, bg), dev)
                self._launched = _build.launches - before
                _build.launches.subtract(self._launched)  # nothing ran yet
            self._key = key
            self.counts["captures"] += 1
        self._last = key
        with span("ts.render.graph_replay"):
            self._graph.replay()
        _build.launches.update(self._launched)
        self.counts["replays"] += 1
        return _cloned(self._out)

    def _drop(self) -> None:
        """Forget the graph, its outputs and its key (its pool goes with it)."""
        self._graph = self._out = self._key = None
        self._launched = Counter()

    def _upload(self, camera: Camera, background, pose_delta, dev):
        """The frame's camera and background in the device buffer, by one
        upload from pinned memory (a device background copied in there):
        (FrameCamera, background), the same views of the buffer each frame."""
        vals = np.zeros(UPLOAD, np.float32)
        vals[VIEW] = np.asarray(camera.view_matrix, np.float32).reshape(-1)
        vals[PROJ] = np.asarray(camera.proj_matrix, np.float32).reshape(-1)
        vals[POS] = np.asarray(camera.position, np.float32)
        vals[[FX, FY, CX, CY]] = camera.f_x, camera.f_y, camera.cx_off, camera.cy_off
        on_host = background is not None and background.device.type == "cpu"
        if on_host:
            vals[BG] = background.detach().to(torch.float32).reshape(3).numpy()
        if self._buffer is None:
            b = self._buffer = torch.empty(BUFFER, dtype=torch.float32, device=dev)
            self._views = (FrameCamera(
                viewmat=b[VIEW].view(4, 4), projmat=b[PROJ].view(4, 4), cam_pos=b[POS],
                fx=b[FX], fy=b[FY], cx_off=b[CX], cy_off=b[CY], full=b[FULL].view(4, 4)),
                b[BG])
        cam, bg = self._views
        host = torch.from_numpy(vals)
        if dev.type == "cuda":
            host = host.pin_memory()
        self._buffer[:UPLOAD].copy_(host, non_blocking=True)
        if background is not None and not on_host:
            bg.copy_(background)
        if pose_delta is not None:
            moved = apply_pose_delta(cam, pose_delta)
            cam.viewmat.copy_(moved.viewmat)
            cam.cam_pos.copy_(moved.cam_pos)
        torch.mm(cam.projmat, cam.viewmat, out=cam.full)
        return cam, bg
