"""The port's live viewer (``tinysplat_torch.viewer``) and ``Trainer.run_async``.

- ``encode_jpeg_base64`` gives the JAX package's string for the same image;
- the protocol of ``tinysplat_tpu.viewer``: a client camera cloned from
  scene camera 0, malformed messages ignored without a frame or an error,
  a depth-1 queue whose fresh request evicts the stale one;
- end to end over a real websocket: the server binds port 0 (the bound
  port is read from the server object once it exists, never a fixed port
  or sleep), a client gets JPEG frames of the live scene while a CPU
  ``Trainer`` runs ``run_async``; the test bounds itself with a timeout;
- frames rendered from the viewer's thread while the trainer steps in
  another leave the trainer's parameters, ``alive``, accumulator, Adam
  moments and count, and generator state bit-equal to the same steps
  without a viewer (the steps include a random background draw, densify
  with capacity growth and an opacity reset).
"""
import asyncio
import base64
import json

import numpy as np
import pytest
import torch

from tinysplat_tpu.viewer import encode_jpeg_base64 as jax_encode_jpeg_base64

import tinysplat_torch as tt
from tinysplat_torch.config import Config
from tinysplat_torch.data.synthetic import orbit_cameras, random_gaussian_cloud, synthetic_pcd
from tinysplat_torch.render import render
from tinysplat_torch.scene import Scene
from tinysplat_torch.train_loop import Trainer
from tinysplat_torch.viewer import Client, Viewer, encode_jpeg_base64

from tests._torch_threads import one_torch_thread  # noqa: F401

SIZE, STEPS = 32, 8
CFG = dict(rasterizer="dense", sh_degree=1, background="random", warmup_grad=0,
           warmup_densify=4, densify_end=100, tau_means=0.0, densify_scale_thresh=1e9,
           interval_opacity_reset=6, nan_guard_interval=4, max_iter=STEPS,
           prefetch_images=False, viewer=False)
CAMERA_INFO = {"type": "cameraInfo", "position": [0.0, 0.0, 3.0], "quat": [1, 0, 0, 0],
               "fovX": 60, "fovY": 60, "near": 0.1, "far": 1000, "aspectRatio": 1.0}


class FakeWS:
    def __init__(self):
        self.sent = []

    async def send(self, data):
        self.sent.append(data)


def toy_trainer():
    """A CPU trainer on 4 orbit views of a 60-splat cloud (ground truth
    rendered by the port), from 40 splats in 64 slots."""
    cams = orbit_cameras(4, width=SIZE, height=SIZE)
    means, log_scales, quats, colors, opac = random_gaussian_cloud(60, seed=7)
    gt = tt.init_from_pcd(means, colors * 255, sh_degree=1, capacity=64, device="cpu")
    with torch.no_grad():
        gt.params.scales[:60] = torch.as_tensor(log_scales)
        gt.params.opacities[:60] = torch.as_tensor(opac)
        for cam in cams:
            cam._image = render(gt.params, gt.alive, cam.params("cpu"), SIZE, SIZE, 1,
                                torch.zeros(3), rasterizer="dense")[0].numpy()
    pcd = synthetic_pcd(40, seed=2)
    state = tt.init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, capacity=64, device="cpu")
    scene = Scene(cams)
    trainer = Trainer(Config(**CFG), scene, state)
    scene.render_fn = lambda camera, dims=None: trainer.render_camera(camera, dims)
    return trainer


def test_encode_jpeg_base64_matches_jax():
    img = np.random.default_rng(0).uniform(0, 1, size=(24, 40, 3)).astype(np.float32)
    s = encode_jpeg_base64(img)
    assert s == jax_encode_jpeg_base64(img)
    assert base64.b64decode(s)[:2] == b"\xff\xd8"


def test_malformed_messages_are_ignored_and_stale_requests_evicted():
    scene = Scene(orbit_cameras(2, width=SIZE, height=SIZE))
    viewer, client = Viewer(scene), Client(FakeWS())
    request = {"type": "renderRequest", "position": [0.1, 0.2, 3.0], "quat": [1, 0, 0, 0]}

    async def run():
        for bad in ("not json", "[1, 2]", json.dumps({"type": "renderRequest",
                                                      "position": [0, 0], "quat": [1, 0, 0, 0]}),
                    json.dumps({"type": "cameraInfo", "position": [0, 0, 0]})):
            await viewer.handle_message(client, bad)
        assert viewer.queue.empty() and client.camera is None
        await viewer.handle_message(client, json.dumps(CAMERA_INFO))
        assert client.camera is not None and client.camera is not scene.cameras[0]
        assert client.camera.name == scene.cameras[0].name
        await viewer.handle_message(client, json.dumps(request))  # evicts cameraInfo
        assert viewer.queue.qsize() == 1
        _, msg = viewer.queue.get_nowait()
        assert msg == request

    asyncio.run(run())
    assert client.ws.sent == []


async def _serve(viewer, timeout=20.0):
    """Start ``viewer.run()`` and wait (bounded) until its server exists;
    returns (task, bound port)."""
    task = asyncio.create_task(viewer.run())

    async def bound():
        while viewer.server is None:
            if task.done():
                task.result()  # raises what stopped the server
            await asyncio.sleep(0.01)

    await asyncio.wait_for(bound(), timeout)
    return task, viewer.server.sockets[0].getsockname()[1]


async def _stop(viewer, task):
    viewer.stop()
    await task
    viewer._queue_task.cancel()


def test_viewer_e2e_over_a_real_websocket_beside_run_async():
    import websockets

    trainer = toy_trainer()
    viewer = Viewer(trainer.scene, ip="127.0.0.1", port=0)
    frames = []

    async def client(port):
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            for msg in (CAMERA_INFO, {"type": "renderRequest", "position": [0.0, 0.5, 3.0],
                                      "quat": [1, 0, 0, 0]}):
                await ws.send(json.dumps(msg))
                frames.append(json.loads(await asyncio.wait_for(ws.recv(), 20)))
                frames[-1]["step"] = trainer.step

    async def run():
        task, port = await _serve(viewer)
        assert port != 0
        await asyncio.gather(trainer.run_async(), client(port))
        await _stop(viewer, task)

    asyncio.run(asyncio.wait_for(run(), 120))
    assert trainer.step == STEPS and len(frames) == 2
    for frame in frames:
        import cv2

        raw = base64.b64decode(frame["image"])
        img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        assert img.shape == (SIZE, SIZE, 3)


def _snapshot(trainer):
    mu, nu, count = trainer.opt_state.moments()
    snap = {f"param {k}": t.detach().clone() for k, t in trainer.state.params.fields()}
    snap.update({f"mu {k}": v.clone() for k, v in mu.items()})
    snap.update({f"nu {k}": v.clone() for k, v in nu.items()})
    snap.update(alive=trainer.state.alive.clone(), accum=trainer.state.means_grad_accum.clone(),
                rng=trainer.generator.get_state(), count=torch.tensor(count),
                cpu_rng=torch.get_rng_state())
    return snap


def test_frames_during_training_leave_the_trainer_bit_equal():
    torch.manual_seed(123)
    quiet = toy_trainer()
    quiet.run()
    ref = _snapshot(quiet)

    torch.manual_seed(123)
    trainer = toy_trainer()
    viewer = Viewer(trainer.scene)
    steps_at_frames = []

    class Looping(FakeWS):
        """A client that asks for the next frame as soon as one arrives."""

        async def send(self, data):
            steps_at_frames.append(trainer.step)
            if trainer.step < STEPS:
                await viewer.handle_message(client, json.dumps(CAMERA_INFO))

    client = Client(Looping())

    async def run():
        consumer = asyncio.create_task(viewer.process_queue())
        await viewer.handle_message(client, json.dumps(CAMERA_INFO))
        await trainer.run_async()
        consumer.cancel()

    asyncio.run(asyncio.wait_for(run(), 120))
    assert trainer.step == STEPS and len(trainer.densify_history) == 2
    assert trainer.state.capacity > 64  # a growth replaced the state mid-run
    assert len({s for s in steps_at_frames if 0 < s < STEPS}) >= 2, steps_at_frames
    got = _snapshot(trainer)
    assert set(got) == set(ref)
    for key, want in ref.items():
        assert torch.equal(got[key], want), key
