"""The port's own profiler spans (``utils.profiling.span``).

JAX-free, so the card's test runs where only the port and CUDA torch are
installed: ``python -m pytest --noconftest tests/test_torch_port_spans.py``.

- With no profiler recording the thread, ``span`` is one shared null
  context: nothing is recorded and nothing allocated.
- Under ``torch.profiler`` on the CPU, a ``Trainer`` step and a
  ``render_camera`` record every span at its layer boundary, each inside the
  span of the layer that called it.
- Under ``densify_strategy="mcmc"`` a step also records the noise's and the
  sparsity terms' spans, and a refine step the relocation's; a plain step
  records none of the three.
- Under ``regularize_density`` a step records the density term's span, and
  a step that rebuilds the probe the rebuild's, its sampling's and its
  KNN's; a plain step records none of the four.
- A step's loss and parameters are bit-equal with the profiler on and off.
- On the card (skipped elsewhere): the spans and the device's kernels share
  one clock. Each launch of K1, K2, S1, S2, L1, L2 and ``scatter_rows`` lies
  inside the span named for its layer, and its kernel starts on the device after that span opened
  (launch and kernel matched by correlation id); the compositing backward's
  and SSIM's backward spans are recorded from autograd's device thread.
"""
import re
import threading

import numpy as np
import pytest
import torch

from tinysplat_torch.config import Config
from tinysplat_torch.data.synthetic import orbit_cameras, synthetic_pcd
from tinysplat_torch.models.gaussians import init_from_pcd
from tinysplat_torch.scene import Scene
from tinysplat_torch.train_loop import Trainer
from tinysplat_torch.utils import profiling

from tests._torch_threads import one_torch_thread  # noqa: F401

CAMS = 2
# The span each span opens inside, in a step (then in a frame).
STEP_PARENT = {
    "ts.trainer.step": None,
    "ts.trainer.camera": "ts.trainer.step",
    "ts.train_step": "ts.trainer.step",
    "ts.train_step.forward": "ts.train_step",
    "ts.render.splat_inputs": "ts.train_step.forward",
    "ts.render.tile_inputs": "ts.train_step.forward",
    "ts.render.composite": "ts.train_step.forward",
    "ts.render.untile": "ts.train_step.forward",
    "ts.train_step.loss": "ts.train_step.forward",
    "ts.ssim": "ts.train_step.loss",
    "ts.train_step.backward": "ts.train_step",
    "ts.ssim.backward": "ts.train_step.backward",
    "ts.composite.backward": "ts.train_step.backward",
    "ts.composite.reduce": "ts.train_step.backward",
    "ts.splat_inputs.backward": "ts.train_step.backward",
    "ts.train_step.accum": "ts.train_step",
    "ts.trainer.post_step": "ts.trainer.step",
    "ts.trainer.log": "ts.trainer.post_step",
    "ts.trainer.nan_guard": "ts.trainer.post_step",
    "ts.trainer.retune": "ts.trainer.post_step",
}
FRAME_PARENT = {
    "ts.trainer.render_camera": None,
    "ts.trainer.camera": "ts.trainer.render_camera",
    "ts.render.splat_inputs": "ts.trainer.render_camera",
    "ts.render.tile_inputs": "ts.trainer.render_camera",
    "ts.render.composite": "ts.trainer.render_camera",
    "ts.render.untile": "ts.trainer.render_camera",
}


def small_trainer(device="cpu", n=40, size=32, **cfg):
    """A ``Trainer`` of ``n`` synthetic splats over ``CAMS`` orbit views at
    ``size`` x ``size`` with random frames as ground truth; K1 and K2 (their
    plain versions on the CPU), a random background and the NaN guard and
    logging every step or two."""
    cams = orbit_cameras(CAMS, width=size, height=size)
    rng = np.random.default_rng(3)
    for cam in cams:
        cam._image = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    pcd = synthetic_pcd(n, seed=2)
    state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, device=device)
    base = dict(rasterizer="auto", sh_degree=1, warmup_densify=10**9,
                interval_opacity_reset=0, nan_guard_interval=2, max_iter=100,
                prefetch_images=False, seed=5)
    base.update(cfg)
    return Trainer(Config(**base), Scene(cams, seed=1), state)


def _kineto(prof):
    return [e for e in prof.profiler.kineto_results.events() if not e.is_hidden_event()]


def recorded_spans(prof):
    """(name, start ns, end ns, thread) of the ``ts.*`` ranges a window
    recorded on the host."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in _kineto(prof)
            if e.name().startswith("ts.") and e.device_type() != cuda]


def parents(spans):
    """Each span's innermost enclosing span (the latest-starting one that
    contains it), on any thread, or None."""
    out = []
    for name, s, e, _ in spans:
        best = None
        for other in spans:
            _, s2, e2, _ = other
            if (s2, e2) != (s, e) and s2 <= s and e <= e2 and (best is None or s2 >= best[1]):
                best = other
        out.append((name, best[0] if best else None))
    return out


def test_untraced_span_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("ts.a") is profiling.span("ts.b") is profiling._UNTRACED
    with profiling.span("ts.a") as got:
        assert got is None
    seen = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert isinstance(profiling.span("ts.a"), torch.profiler.record_function)
        with profiling.span("ts.outer"):
            pass
        # A thread started under the profiler is not recorded: its span is
        # the null context.
        t = threading.Thread(target=lambda: seen.update(ctx=profiling.span("ts.other")))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen["ctx"] is profiling._UNTRACED
    assert [s[0] for s in recorded_spans(prof)] == ["ts.outer"]


def test_op_range_is_an_operator_range_only_when_traced():
    """``op_range`` (around the SSIM kernels' ctypes launches) is the null
    context untraced, and under the profiler an operator-scope range (the
    profiler links a launch's kernel to the innermost operator, never to a
    span), nested in the span around it."""
    assert profiling.op_range("ssim_bwd") is profiling._UNTRACED
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("ts.outer"):
            with profiling.op_range("ssim_bwd"):
                torch.ones(3).add_(1)
    got = {e.name: e for e in prof.events() if e.name in ("ts.outer", "ssim_bwd")}
    assert not got["ssim_bwd"].is_user_annotation and got["ts.outer"].is_user_annotation
    assert got["ssim_bwd"].cpu_parent.name == "ts.outer"


def test_a_step_and_a_frame_record_every_span_nested():
    tr = small_trainer()
    tr.train_step()  # step 1: past the first call's one-off work
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu) as prof:
        tr.train_step()  # step 2: an epoch boundary (log) and a NaN-guard check
    got = parents(recorded_spans(prof))
    assert set(got) == set(STEP_PARENT.items()), sorted(set(got) ^ set(STEP_PARENT.items()))
    counts = {n: sum(1 for m, _ in got if m == n) for n in STEP_PARENT}
    assert counts["ts.trainer.step"] == 1 and counts["ts.render.untile"] == 2
    with torch.profiler.profile(activities=cpu) as prof:
        tr.render_camera(tr.scene.cameras[0])
    assert set(parents(recorded_spans(prof))) == set(FRAME_PARENT.items())


# 3DGS-MCMC's spans and the span each opens inside.
MCMC_PARENT = {
    "ts.train_step.mcmc_sparsity": "ts.train_step.loss",
    "ts.train_step.mcmc_noise": "ts.train_step.accum",
    "ts.trainer.mcmc_relocate": "ts.trainer.post_step",
}


def test_mcmc_steps_record_their_spans_and_plain_steps_none():
    cpu = [torch.profiler.ProfilerActivity.CPU]
    tr = small_trainer(densify_strategy="mcmc", mcmc_refine_every=4, warmup_densify=0)
    got = {}
    for step in (1, 2, 3, 4):  # steps 2 and 4 traced, epoch boundaries; 4 refines
        if step % 2:
            tr.train_step()
            continue
        with torch.profiler.profile(activities=cpu) as prof:
            tr.train_step()
        got[step] = set(parents(recorded_spans(prof)))
    assert [e["step"] for e in tr.densify_history] == [4]
    every = set(STEP_PARENT.items())
    step_only = {(k, v) for k, v in MCMC_PARENT.items() if k != "ts.trainer.mcmc_relocate"}
    assert got[2] == every | step_only, sorted(got[2] ^ (every | step_only))
    assert got[4] == every | set(MCMC_PARENT.items()), sorted(got[4] ^ every)
    plain = small_trainer(warmup_densify=0, mcmc_refine_every=4)
    plain.train_step()
    with torch.profiler.profile(activities=cpu) as prof:
        plain.train_step()
        plain.train_step()
    assert not {n for n, _ in parents(recorded_spans(prof))} & set(MCMC_PARENT)


# SuGaR density's spans and the span each opens inside.
DENSITY_PARENT = {
    "ts.train_step.density": "ts.train_step.loss",
    "ts.trainer.density_probe": "ts.trainer.step",
    "ts.density.sample": "ts.trainer.density_probe",
    "ts.density.knn": "ts.trainer.density_probe",
}


def test_density_steps_record_their_spans_and_plain_steps_none():
    cpu = [torch.profiler.ProfilerActivity.CPU]
    # The window from step 0, so no step is its start (whose prune would
    # empty a fresh cloud); the probe rebuilt on odd steps.
    tr = small_trainer(regularize_density=True, regularize_density_start=0,
                       interval_densify=2, density_samples=64)
    got = {}
    for step in (1, 2, 3):  # steps 2 and 3 traced; 1 and 3 rebuild the probe
        if step == 1:
            tr.train_step()
            continue
        with torch.profiler.profile(activities=cpu) as prof:
            tr.train_step()
        got[step] = set(parents(recorded_spans(prof)))
    assert [e["step"] for e in tr.probe_history] == [1, 3]
    every = set(STEP_PARENT.items())
    term = {("ts.train_step.density", "ts.train_step.loss")}
    assert got[2] == every | term, sorted(got[2] ^ (every | term))
    # Step 3 is no epoch boundary: no log.
    log = {("ts.trainer.log", "ts.trainer.post_step")}
    rebuild = (every - log) | set(DENSITY_PARENT.items())
    assert got[3] == rebuild, sorted(got[3] ^ rebuild)
    plain = small_trainer()
    plain.train_step()
    with torch.profiler.profile(activities=cpu) as prof:
        plain.train_step()
        plain.train_step()
    assert not {n for n, _ in parents(recorded_spans(prof))} & set(DENSITY_PARENT)


def test_step_bit_equal_with_the_profiler_on_and_off():
    runs = []
    for traced in (False, True):
        tr = small_trainer()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        if traced:
            prof.start()
        for _ in range(3):
            tr.train_step()
        if traced:
            prof.stop()
            assert recorded_spans(prof)
        runs.append((tr.last_metrics["loss"].clone(),
                     {k: t.detach().clone() for k, t in tr.state.params.fields()}))
    (loss0, p0), (loss1, p1) = runs
    assert torch.equal(loss0, loss1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


# The span each kernel's launch must lie in: K1, K2, S1, S2, L1, L2 and the
# compositing backward's reduction.
KERNEL_SPAN = {"composite_fwd_kernel": "ts.render.composite",
               "composite_bwd_kernel": "ts.composite.backward",
               "splat_fwd_kernel": "ts.render.splat_inputs",
               "splat_bwd_kernel": "ts.splat_inputs.backward",
               "ssim_fwd_kernel": "ts.ssim",
               "ssim_bwd_kernel": "ts.ssim.backward",
               "scatter_rows_kernel": "ts.composite.reduce"}


@pytest.mark.cuda
def test_spans_share_the_device_clock_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")
    tr = small_trainer("cuda", n=20_000, size=256)
    for _ in range(2):
        tr.train_step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tr.train_step()
        torch.cuda.synchronize()
    events = _kineto(prof)
    cuda = torch.autograd.DeviceType.CUDA
    spans = recorded_spans(prof)
    host = {e.correlation_id(): e for e in events
            if e.device_type() != cuda and e.correlation_id() and "Launch" in e.name()}
    found = dict.fromkeys(KERNEL_SPAN, 0)
    for k in events:
        if k.device_type() != cuda or k.is_user_annotation():
            continue
        for symbol, span_name in KERNEL_SPAN.items():
            if not re.search(r"(?<![A-Za-z0-9_])" + symbol + r"(?![A-Za-z0-9_])", k.name()):
                continue
            launch = host[k.correlation_id()]
            ls, le = launch.start_ns(), launch.start_ns() + launch.duration_ns()
            inside = [(s, e) for n, s, e, _ in spans if n == span_name and s <= ls and le <= e]
            assert len(inside) == 1, (symbol, span_name)
            assert k.start_ns() > inside[0][0], symbol
            found[symbol] += 1
    assert all(found.values()), found
    step_thread = {t for n, _, _, t in spans if n == "ts.trainer.step"}
    bwd_thread = {t for n, _, _, t in spans if n == "ts.composite.backward"}
    assert len(step_thread) == 1 and len(bwd_thread) == 1 and bwd_thread != step_thread
    assert {t for n, _, _, t in spans if n == "ts.ssim.backward"} == bwd_thread
    assert {t for n, _, _, t in spans if n == "ts.composite.reduce"} == bwd_thread
    # The profiler's own op tree puts each SSIM kernel and the reduction's
    # kernel under its span too (what the benchmark's ssim_kernel_ms.train and
    # grad_reduce_device_ms.train sum): L2 and the reduction through their
    # operator ranges, inside the span inside autograd's node.

    def subtree(e):
        return [k.name for k in e.kernels] + [n for c in e.cpu_children for n in subtree(c)]

    for span_name, kernel in (("ts.ssim", "ssim_fwd_kernel"),
                              ("ts.ssim.backward", "ssim_bwd_kernel"),
                              ("ts.composite.reduce", "scatter_rows_kernel")):
        names = [n for e in prof.events() if e.name == span_name
                 and e.device_type == torch.autograd.DeviceType.CPU for n in subtree(e)]
        assert sum(kernel in n for n in names) == 1, (span_name, names)
