"""Live websocket viewer server (torch port of ``tinysplat_tpu.viewer``).

Wire-protocol compatible with the reference framework's viewer (its
tinysplat/viewer.py and viewer/main.js): JSON messages
`{"type": "cameraInfo", ...}` / `{"type": "renderRequest", "position": [...],
"quat": [...], "aspectRatio": ...}` in, `{"image": <base64 jpeg>}` out.
Behavioral parity points:

- per-client camera cloned from scene camera 0;
- render-request queue of depth 1 with stale-request eviction;
- malformed messages are logged and ignored, never fatal to the connection;
- renders with a black background through the scene's bound render
  callable (``Trainer.render_camera`` in ``train_cli``), in an executor
  thread, so the event loop keeps serving sockets while a frame renders;
- JPEG + base64 frames, ~0.02 s pacing.

A frame may render while a ``Trainer`` steps in another thread: the trainer
holds its lock across a step and across ``render_camera``, so a frame sees
a whole step. With several ranks (``torch.distributed``), only rank 0
serves: ``run`` returns at once on the others.

The browser client lives in viewer/ (same protocol).
"""
from __future__ import annotations

import asyncio
import base64
import copy
import json
import logging
from typing import Set

import numpy as np

log = logging.getLogger(__name__)


def encode_jpeg_base64(img01: np.ndarray) -> str:
    """float [0,1] HxWx3 RGB -> base64 JPEG string."""
    arr = np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)
    try:
        import cv2

        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
        data = buf.tobytes()
    except ImportError:  # pragma: no cover
        import io

        from PIL import Image

        bio = io.BytesIO()
        Image.fromarray(arr).save(bio, format="JPEG")
        data = bio.getvalue()
    return base64.b64encode(data).decode("utf-8")


class Client:
    def __init__(self, websocket):
        self.ws = websocket
        self.camera = None

    async def send_image(self, img01: np.ndarray) -> None:
        await self.ws.send(json.dumps({"image": encode_jpeg_base64(img01)}))


class Viewer:
    """Serves interactive renders of the (live, training) scene."""

    def __init__(self, scene, ip: str = "127.0.0.1", port: int = 8765):
        self.scene = scene
        self.ip = ip
        self.port = port
        self.server = None
        self.clients: Set[Client] = set()
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=1)

    async def handle_client(self, websocket) -> None:
        client = Client(websocket)
        self.clients.add(client)
        try:
            async for message in websocket:
                await self.handle_message(client, message)
        finally:
            self.clients.discard(client)

    async def handle_message(self, client: Client, message: str) -> None:
        # Tolerate garbage frames (proxies, extensions, buggy clients):
        # one malformed message must not tear the connection down, and a
        # malformed pose must never reach the render task.
        try:
            msg = json.loads(message)
            if not isinstance(msg, dict):
                raise ValueError("non-object message")
            if "position" in msg or "quat" in msg:
                pos = np.asarray(msg["position"], np.float32)
                quat = np.asarray(msg["quat"], np.float32)
                if pos.shape != (3,) or quat.shape != (4,):
                    raise ValueError("bad pose shapes")
        except (ValueError, KeyError, TypeError):
            log.warning("ignoring malformed viewer message")
            return
        if msg.get("type") == "cameraInfo":
            client.camera = copy.copy(self.scene.cameras[0])
            await self._enqueue(client, msg)
        elif msg.get("type") == "renderRequest":
            await self._enqueue(client, msg)

    async def _enqueue(self, client: Client, msg: dict) -> None:
        # Depth-1 queue: a fresh request evicts a stale unprocessed one.
        if self.queue.full():
            try:
                _ = self.queue.get_nowait()
            except asyncio.QueueEmpty:
                pass
        await self.queue.put((client, msg))

    def _frame(self, camera) -> np.ndarray:
        """One frame as a host array (runs in the executor thread, so the
        device-to-host copy does not block the event loop)."""
        rgb, _ = self.scene.render(camera)
        if hasattr(rgb, "detach"):  # a tensor, possibly on the card
            rgb = rgb.detach().cpu().numpy()
        return np.asarray(rgb)

    async def process_queue(self) -> None:
        # The ONE consumer for every client: nothing in the loop body may
        # kill it — a mid-render disconnect or a bad pose affects only that
        # frame (every future client would otherwise go dark silently).
        while True:
            client, msg = await self.queue.get()
            try:
                if client.camera is None:
                    continue
                if "position" in msg and "quat" in msg:
                    client.camera.update_view_matrix(
                        np.asarray(msg["position"], np.float32),
                        np.asarray(msg["quat"], np.float32),
                    )
                loop = asyncio.get_running_loop()
                rgb = await loop.run_in_executor(None, self._frame, client.camera)
                await client.send_image(rgb)
            except Exception:  # keep serving: bad frame/pose/disconnect
                log.exception("viewer frame dropped")
            await asyncio.sleep(0.02)

    async def run(self) -> None:
        import torch.distributed as dist
        import websockets

        if dist.is_initialized() and dist.get_rank() != 0:  # rank 0 serves
            return

        # ping_interval=None: a first frame builds the kernels, which can
        # block a render for seconds; default keepalives would drop clients.
        self.server = await websockets.serve(
            self.handle_client, self.ip, self.port, ping_interval=None
        )
        log.info("viewer listening on ws://%s:%d", self.ip,
                 self.server.sockets[0].getsockname()[1])
        # Hold a strong reference: asyncio keeps only a weak ref to tasks,
        # so an anonymous consumer could be garbage-collected mid-run (and
        # its death would be unobservable).
        self._queue_task = asyncio.create_task(self.process_queue())
        await self.server.wait_closed()

    def stop(self) -> None:
        if self.server is not None:
            self.server.close()
