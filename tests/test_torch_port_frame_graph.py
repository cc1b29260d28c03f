"""The frame graph's logic (``tinysplat_torch.frame_graph``) on the CPU.

``Trainer.render_camera`` renders through a ``FrameGraph``, which on the
card captures a frame's render into a CUDA graph once its key repeats and
replays it after. Here the card is faked: ``_on_card`` answers yes for CPU
tensors and ``_capture`` returns a ``FakeGraph``, which runs the draw once at
capture and, on each replay, runs it again and writes the results into the
outputs of the capture in place, as a CUDA graph overwrites its static
outputs. A replay launches nothing through ``_build.launch``, so the fake's
replay leaves ``_build.launches`` as it found it. The renders themselves
are the port's plain versions (K1's on the CPU), so frames are compared
with an eager render of the same camera bit for bit.
"""
import dataclasses
import gc
import weakref

import pytest
import torch

from tinysplat_torch import frame_graph as fg
from tinysplat_torch.cameras import apply_pose_delta
from tinysplat_torch.config import Config
from tinysplat_torch.data.synthetic import orbit_cameras, synthetic_pcd
from tinysplat_torch.models.gaussians import init_from_pcd
from tinysplat_torch.ops import _build
from tinysplat_torch.render import render
from tinysplat_torch.scene import Scene
from tinysplat_torch.train_loop import Trainer

from tests._torch_threads import one_torch_thread  # noqa: F401

SIZE = 24


def trainer(**cfg):
    """A ``Trainer`` of 40 synthetic splats over 3 orbit views at SIZE x SIZE."""
    cams = orbit_cameras(3, width=SIZE, height=SIZE)
    pcd = synthetic_pcd(40, seed=2)
    state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, device="cpu")
    base = dict(rasterizer="auto", sh_degree=1, warmup_densify=10**9, prefetch_images=False,
                tile_x=0, seed=5)
    base.update(cfg)
    return Trainer(Config(**base), Scene(cams, seed=1), state)


def drawer(s, c, w, h):
    """``render_camera``'s draw: state ``s`` rendered under config ``c`` at
    (w, h)."""

    def draw(params, bg):
        return render(s.params, s.alive, params, h, w, s.active_sh_degree, bg,
                      rasterizer=c.rasterizer, viewdirs_mode=c.viewdirs_mode,
                      tile_size=c.tile_size, dup_capacity=c.dup_capacity,
                      max_per_tile=c.max_per_tile, span_capacity=c.span_capacity,
                      grad_reduce=c.grad_reduce, tile_x=c.tile_x, antialiased=c.antialiased)

    return draw


def eager(tr, cam, dims=None, background=None):
    """The frame as ``render_camera`` drew it before: ``Camera.params``, the
    pose delta, ``render``."""
    w, h = dims or (cam.width, cam.height)
    params = cam.params("cpu")
    slot = tr._pose_slot(cam)
    if slot is not None and tr.pose_deltas is not None:
        params = apply_pose_delta(params, tr.pose_deltas[slot])
    with torch.no_grad():
        return drawer(tr.state, tr.cfg, w, h)(params, background if background is not None
                                else torch.zeros(3))


def _write(dst, src):
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _write(d, s)


class FakeGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        saved = _build.launches.copy()
        _write(self.out, self.fn())
        _build.launches.clear()
        _build.launches.update(saved)


@pytest.fixture
def card(monkeypatch):
    """The card faked for CPU tensors; the fake graphs captured, in order."""
    graphs = []

    def capture(fn, device):
        out = fn()
        graphs.append(FakeGraph(fn, out))
        return graphs[-1], out

    monkeypatch.setattr(fg, "_on_card", lambda t: True)
    monkeypatch.setattr(fg, "_capture", capture)
    return graphs


def same(a, b):
    """Two frames (rgb, extras) equal bit for bit, extras key by key."""
    (rgb_a, ex_a), (rgb_b, ex_b) = a, b
    assert torch.equal(rgb_a, rgb_b)
    assert set(ex_a) == set(ex_b)
    for k in ("depth", "alpha", "radii", "xys", "depths"):
        assert torch.equal(ex_a[k], ex_b[k]), k
    assert ex_a["camera"] == ex_b["camera"]
    assert set(ex_a.get("binning", {})) == set(ex_b.get("binning", {}))
    for k in ex_a.get("binning", {}):
        assert torch.equal(ex_a["binning"][k], ex_b["binning"][k]), k


@pytest.mark.parametrize("case", ["cpu tensors", "grad enabled", "dense rasterizer"])
def test_these_frames_run_eagerly(case, monkeypatch):
    tr = trainer(rasterizer="dense" if case == "dense rasterizer" else "auto")
    if case != "cpu tensors":
        monkeypatch.setattr(fg, "_on_card", lambda t: True)
    monkeypatch.setattr(fg, "_capture", lambda fn, device: pytest.fail("captured"))
    cam = tr.scene.cameras[0]
    frames = []
    for _ in range(3):
        if case == "grad enabled":
            draw = drawer(tr.state, tr.cfg, SIZE, SIZE)
            frames.append(tr._frames.render(draw, tr.state, tr.cfg, cam, SIZE, SIZE))
        else:
            frames.append(tr.render_camera(cam))
    assert tr._frames.counts == {"eager": 3}
    assert tr._frames._buffer is None  # the camera went through Camera.params
    for f in frames:
        same(f, eager(tr, cam))


def test_a_key_captures_on_its_second_frame_and_replays_after(card):
    tr = trainer()
    cams = tr.scene.cameras
    f1 = tr.render_camera(cams[0])
    assert tr._frames.counts == {"eager": 1} and not card
    f2 = tr.render_camera(cams[1])
    assert tr._frames.counts == {"eager": 1, "captures": 1, "replays": 1} and len(card) == 1
    f3 = tr.render_camera(cams[2])
    kept = (f3[0].clone(), f3[1]["depth"].clone())
    f4 = tr.render_camera(cams[0])
    assert tr._frames.counts == {"eager": 1, "captures": 1, "replays": 3} and len(card) == 1
    for f, cam in zip((f1, f2, f3, f4), (cams[0], cams[1], cams[2], cams[0])):
        same(f, eager(tr, cam))
    # The frame the caller kept is its own: the next replay left it alone.
    assert torch.equal(f3[0], kept[0]) and torch.equal(f3[1]["depth"], kept[1])
    assert not torch.equal(f3[0], f4[0])
    assert f4[0].data_ptr() != card[0].out[0].data_ptr()


def _change(tr, what):
    """Change one part of the frame's key."""
    p = tr.state.params
    if what == "replaced leaf":
        tr.state.params = dataclasses.replace(p, means=p.means.clone())
    elif what == "reshaped leaf":
        tr.state.params = dataclasses.replace(p, opacities=p.opacities.reshape(-1))
    elif what == "config field":
        tr.cfg = dataclasses.replace(tr.cfg, dup_capacity=4096)
    elif what == "alive":
        tr.state = dataclasses.replace(tr.state, alive=tr.state.alive.clone())


@pytest.mark.parametrize("what", ["size", "replaced leaf", "reshaped leaf", "config field",
                                  "alive"])
def test_a_changed_key_drops_the_graph_and_recaptures(card, what):
    tr = trainer()
    cam = tr.scene.cameras[0]
    dims = None
    for _ in range(3):
        tr.render_camera(cam)
    assert tr._frames._graph is card[0]
    if what == "size":
        dims = (SIZE + 16, SIZE - 8)
    else:
        _change(tr, what)
    first = tr.render_camera(cam, dims)
    assert tr._frames._graph is None and tr._frames._out is None
    assert tr._frames.counts == {"eager": 2, "captures": 1, "replays": 2}
    second = tr.render_camera(cam, dims)
    assert tr._frames._graph is card[1]
    assert tr._frames.counts == {"eager": 2, "captures": 2, "replays": 3}
    want = eager(tr, cam, dims)
    same(first, want)
    same(second, want)


def test_a_new_camera_or_background_keeps_the_key(card):
    tr = trainer(pose_opt=True)
    tr.pose_deltas.copy_(torch.tensor([[0.02, -0.01, 0.03, 0.05, 0.0, -0.04]] * 3))
    cams = tr.scene.cameras
    gen = torch.Generator().manual_seed(0)
    for i in range(6):
        cam = cams[i % 3]
        bg = torch.rand(3, generator=gen) if i % 2 else None
        got = tr.render_camera(cam, background=bg)
        same(got, eager(tr, cam, background=bg))
    assert tr._frames.counts == {"eager": 1, "captures": 1, "replays": 5} and len(card) == 1


def test_a_replay_adds_the_launches_its_capture_counted(card):
    tr = trainer()
    cam = tr.scene.cameras[0]
    out = eager(tr, cam)

    def draw(c, bg):  # as the card's render counts its eight launches
        for symbol, n in (("splat_fwd", 1), ("bin_count", 1), ("bin_emit", 1),
                          ("radix_hist", 2), ("radix_scatter", 2), ("composite_fwd", 1)):
            _build.launches[symbol] += n
        return out

    frames = tr._frames
    seen = []
    for _ in range(4):
        before = _build.launches.copy()
        with torch.no_grad():
            frames.render(draw, tr.state, tr.cfg, cam, SIZE, SIZE)
        seen.append(dict(_build.launches - before))
    every = {"splat_fwd": 1, "bin_count": 1, "bin_emit": 1, "radix_hist": 2,
             "radix_scatter": 2, "composite_fwd": 1}
    assert seen == [every] * 4  # eager, capture + replay, replay, replay
    assert frames.counts == {"eager": 1, "captures": 1, "replays": 3}
    assert frames._launched == every


def test_no_reference_to_a_state_leaf_is_held(card):
    tr = trainer()  # for its state, config and camera; its optimizer holds the state
    state, cfg, cam = dataclasses.replace(tr.state), tr.cfg, tr.scene.cameras[0]
    state.params = dataclasses.replace(state.params, means=state.params.means.clone())
    frames = fg.FrameGraph()
    with torch.no_grad():
        for _ in range(3):
            frames.render(drawer(state, cfg, SIZE, SIZE), state, cfg, cam, SIZE, SIZE)

    def tensors(x):
        if torch.is_tensor(x):
            return 1
        return sum(tensors(y) for y in x) if isinstance(x, tuple) else 0

    assert frames._graph is card[0] and frames.counts["replays"] == 2
    assert tensors(frames._key) == 0 and tensors(frames._last) == 0
    old = weakref.ref(state.params.means)
    state.params = dataclasses.replace(state.params, means=state.params.means.clone())
    with torch.no_grad():  # a new key: the graph goes
        frames.render(drawer(state, cfg, SIZE, SIZE), state, cfg, cam, SIZE, SIZE)
    card.clear()  # the fake graph held its draw, and so the old state
    gc.collect()
    assert old() is None


def test_frame_camera_equals_camera_params():
    """The packed camera holds ``Camera.params``' values and the product of
    its matrices."""
    tr = trainer()
    cam = tr.scene.cameras[1]
    packed, bg = fg.FrameGraph()._upload(cam, torch.tensor([0.25, 0.5, 1.0]), None,
                                         torch.device("cpu"))
    ref = cam.params("cpu")
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(packed, f.name), getattr(ref, f.name)), f.name
    assert torch.equal(packed.full_projmat, ref.projmat @ ref.viewmat)
    assert torch.equal(bg, torch.tensor([0.25, 0.5, 1.0]))


def test_the_benchmark_reads_one_replay_a_traced_frame(card):
    """``frame_graph_pct.serve`` (the benchmark's reader) over a profiled
    window of the trainer's frames: 100 where every frame replayed, 50 where
    one of two ran eagerly, nothing where none replayed."""
    import types

    from splatbench import spec
    from splatbench.trace import Trace

    read = spec.metric_reader("frame_graph_pct.serve")
    tr = trainer()
    cams = tr.scene.cameras
    cpu = [torch.profiler.ProfilerActivity.CPU]
    got = []
    for frames in ([cams[0]], [cams[1], cams[2]], [cams[0], cams[0]]):
        with torch.profiler.profile(activities=cpu) as prof:
            for cam in frames:
                tr.render_camera(cam, dims=(SIZE, SIZE + 8) if len(got) == 2 else None)
        got.append(read(types.SimpleNamespace(trace=Trace(prof), calls=len(frames))))
    # eager; capture + replay, replay; a new size: eager, capture + replay
    assert got == [None, 100.0, 50.0]
