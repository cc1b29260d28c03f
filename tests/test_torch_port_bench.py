"""The port's headline bench (``tinysplat_torch/scripts/bench.py``) against
the JAX package's root ``bench.py``.

- The flags (names, defaults, types, choices) are ``bench.py``'s plus
  ``--device``, read from its source with ``ast``: importing it would
  switch JAX's compile-cache directory (bench.py:66-72).
- The scene is ``__graft_entry__._example_state(n, n, scale_range=(0.002,
  0.01))`` exactly, the camera JAX's ``orbit_cameras(1, W, H)[0]``, and the
  headline's ``config`` what bench.py:100-102 computes.
- At 2,048 splats and 64x96, the port's bench gradient on the CPU (the
  plain K1 / K2, and K3 under "mxu") equals the gradient of bench.py's loss
  (bench.py:104-119) through JAX's ``tiled`` rasterizer, the one bench.py
  picks off the TPU: the loss to rtol 1e-5, each field to 5e-4 x its max
  (ROADMAP.md's tolerances). One train step from the bench scene with the
  all-zero ground truth equals JAX's ``make_train_step`` at the same
  ``Config`` (JAX's background draw handed over): the loss to rtol 1e-5 and
  every parameter after the step to 5e-4 x its max.
- ``main`` prints the headline and the final line last, with
  ``BENCH_r05.json``'s keys; with no card it prints the JSON error line
  and exits 1 before any work.
"""
import argparse
import ast
import dataclasses
import functools
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_torch.render import render
from tinysplat_torch.scripts import bench
from tinysplat_torch.train import init_opt_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(REPO, "bench.py")
N, H, W = 2048, 64, 96
SMALL = ["--device", "cpu", "--n", str(N), "--height", str(H), "--width", str(W)]
LOSS_RTOL, FIELD_TOL = 1e-5, 5e-4
TRAIN_KEYS = {"train_step_ms", "train_steps_per_s", "rays_per_s"}
FIELDS = ("means", "colors_dc", "colors_rest", "scales", "quats", "opacities")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops run on the calling thread only. In a process that had
    run JAX, torch's ``exp`` of the 6,144 log-scales came back up to 1.5e-4
    off on one worker thread's chunk in a few first calls (the calling
    thread's chunk never was), which moved the bench gradient 5.7e-4 x max;
    the plain compositing walk is no faster on more threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jax_bench_flags():
    """{option: (default, type name, choices, action)} of bench.py's
    ``add_argument`` calls, from its source."""
    with open(JAX_BENCH) as f:
        tree = ast.parse(f.read(), filename=JAX_BENCH)
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            action = kw["action"].value if "action" in kw else None
            default = (eval(compile(ast.Expression(kw["default"]), JAX_BENCH, "eval"), {})
                       if "default" in kw else (False if action == "store_true" else None))
            flags[node.args[0].value] = (
                default, kw["type"].id if "type" in kw else None,
                ast.literal_eval(kw["choices"]) if "choices" in kw else None, action)
    return flags


def test_flags_are_the_jax_benchs_plus_device():
    ours = {}
    for a in bench.arg_parser()._actions:
        if a.dest == "help":
            continue
        (opt,) = a.option_strings
        ours[opt] = (a.default, a.type.__name__ if a.type else None, a.choices,
                     "store_true" if isinstance(a, argparse._StoreTrueAction) else None)
    assert ours.pop("--device") == ("cuda", None, None, None)
    theirs = jax_bench_flags()
    assert len(theirs) == 11 and theirs["--n"][0] == 1 << 18
    assert ours == theirs


@functools.cache
def graft_entry():
    """The JAX package's ``__graft_entry__``, loaded by path with the
    suite's compile-cache directory put back."""
    saved = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("jax_graft_entry_bench",
                                                  os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    return mod


def jax_scene():
    """bench.py:86-89 at N splats and H x W: the state and camera."""
    from tinysplat_tpu.data.synthetic import orbit_cameras

    state = graft_entry()._example_state(n=N, capacity=N, scale_range=(0.002, 0.01))
    return state, orbit_cameras(1, width=W, height=H)[0].params()


def small_args(*extra):
    return bench.arg_parser().parse_args(SMALL + list(extra))


def test_scene_camera_and_config_are_the_jax_benchs():
    jst, jcam = jax_scene()
    state, cam, background = bench.bench_scene(N, H, W, "cpu")
    for name, t in state.params.fields():
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jst.params, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(state.alive.numpy(), np.asarray(jst.alive))
    assert state.capacity == N and bool(state.alive.all())
    for f in dataclasses.fields(cam):
        np.testing.assert_array_equal(getattr(cam, f.name).numpy(),
                                      np.asarray(getattr(jcam, f.name)), err_msg=f.name)
    assert torch.equal(background, torch.zeros(3))

    # bench.py:100-102, and the headline's "config" in bench.py:146-149's order.
    want = {"tile_x": 64, "grad_reduce": "scatter", "chunk": 128, "tiles_per_block": 8,
            "dup_capacity": int(760_000 * N / (1 << 18)),
            "span_capacity": int(786_432 * N / (1 << 18))}
    kw = bench.render_kw(small_args())
    assert list(bench.CONFIG_KEYS) == list(want)
    assert {k: kw[k] for k in bench.CONFIG_KEYS} == want and kw["max_per_tile"] == 4096
    kw = bench.render_kw(small_args("--dup-capacity", "7000", "--span-capacity", "6500"))
    assert (kw["dup_capacity"], kw["span_capacity"]) == (7000, 6500)


@functools.cache
def jax_bench_grad():
    """bench.py:104-119's loss, its gradient and the render's binning
    counters, with the ``tiled`` rasterizer, as numpy."""
    from tinysplat_tpu.render import render as jax_render

    jst, jcam = jax_scene()
    kw = bench.render_kw(small_args())

    def loss_fn(params):
        rgb, extras = jax_render(params, jst.alive, jcam, H, W,
                                 active_sh_degree=jnp.int32(3),
                                 background=jnp.zeros((3,), jnp.float32), rasterizer="tiled",
                                 **kw)
        return jnp.sum(rgb) + jnp.sum(extras["depth"]), extras["binning"]

    (loss, diag), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jst.params)
    return (float(loss), {k: np.asarray(getattr(grads, k)) for k in FIELDS},
            {k: int(v) for k, v in jax.device_get(diag).items()})


def close_to_max(got, ref, name):
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, atol=FIELD_TOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("grad_reduce", ["scatter", "mxu"])
def test_render_gradient_matches_jax(grad_reduce):
    kw = bench.render_kw(small_args("--grad-reduce", grad_reduce))
    state, cam, background = bench.bench_scene(N, H, W, "cpu")
    grads, diag = bench.render_grad(state, cam, background, H, W, **kw)()
    assert int(diag["dup_dropped"]) == int(diag["tile_dropped"]) == 0
    with torch.no_grad():
        rgb, extras = render(state.params, state.alive, cam, H, W, 3, background, **kw)
    ref_loss, ref_grads, ref_diag = jax_bench_grad()
    assert ref_diag["dup_dropped"] == ref_diag["tile_dropped"] == 0
    np.testing.assert_allclose(float(rgb.sum() + extras["depth"].sum()), ref_loss,
                               rtol=LOSS_RTOL)
    for (name, _), g in zip(state.params.fields(), grads):
        assert float(g.abs().max()) > 0, name
        close_to_max(g.numpy(), ref_grads[name], name)


def jax_background():
    """The background of bench.py's train steps: ``Config``'s "random",
    drawn from PRNGKey(0) (bench.py:166)."""
    from tinysplat_tpu import train as jt
    from tinysplat_tpu.config import Config as JaxConfig

    return np.array(jt._resolve_background(JaxConfig(), jax.random.PRNGKey(0)))


@functools.cache
def jax_bench_step(grad_reduce):
    """bench.py:162-171's first train step: its ``Config``, the loss and the
    parameters after the step, as numpy."""
    from tinysplat_tpu import train as jt
    from tinysplat_tpu.config import Config as JaxConfig

    jst, jcam = jax_scene()
    kw = bench.render_kw(small_args("--grad-reduce", grad_reduce))
    cfg = JaxConfig(rasterizer="tiled", sh_degree=3, dup_capacity=kw["dup_capacity"],
                    span_capacity=kw["span_capacity"], max_per_tile=4096,
                    tile_x=kw["tile_x"], grad_reduce=grad_reduce,
                    tiles_per_block=kw["tiles_per_block"])
    key = jax.random.PRNGKey(0)
    out = jt.make_train_step(cfg, H, W)(jst, jt.init_opt_state(cfg, jst), jcam,
                                       jnp.zeros((H, W, 3), jnp.float32), None, jnp.int32(0),
                                       key)
    return (cfg, float(out.metrics["loss"]),
            {k: np.asarray(getattr(out.state.params, k)) for k in FIELDS})


@pytest.mark.parametrize("grad_reduce", ["scatter", "mxu"])
def test_train_step_matches_jax(grad_reduce):
    cfg = bench.train_config(small_args("--grad-reduce", grad_reduce))
    state, cam, _ = bench.bench_scene(N, H, W, "cpu")
    out = make_train_step(cfg, H, W)(state, init_opt_state(cfg, state), cam,
                                     torch.zeros((H, W, 3)), None, 0,
                                     background=torch.from_numpy(jax_background()))
    assert int(out.metrics["n_dup_dropped"]) == int(out.metrics["n_tile_dropped"]) == 0
    jcfg, ref_loss, ref_params = jax_bench_step(grad_reduce)
    assert dataclasses.asdict(cfg) == dict(dataclasses.asdict(jcfg), rasterizer="auto",
                                           mcmc_refine_every=0)
    np.testing.assert_allclose(float(out.metrics["loss"]), ref_loss, rtol=LOSS_RTOL)
    for name, t in out.state.params.fields():
        close_to_max(t.detach().numpy(), ref_params[name], name)


def json_lines(text):
    return [json.loads(s) for s in text.strip().splitlines() if s.startswith("{")]


def test_main_prints_the_jax_benchs_lines(capsys):
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        keys = set(json.load(f)["parsed"])
    history = {}
    record = bench.main(SMALL + ["--iters", "2"], history=history)
    lines = capsys.readouterr().out.strip().splitlines()
    headline, final = (json.loads(s) for s in lines[-2:])
    assert final == record and len(json_lines("\n".join(lines))) == 2
    assert set(headline) == keys - TRAIN_KEYS and set(final) == keys
    assert {k: final[k] for k in headline} == headline
    assert headline["metric"] == bench.METRIC and headline["unit"] == "Msplats/s"
    assert headline["n_splats"] == N and headline["resolution"] == [H, W]
    assert final["value"] > 0 and final["train_step_ms"] > 0 and final["rays_per_s"] > 0
    assert history["binning"]["dup_dropped"] == history["binning"]["tile_dropped"] == 0
    assert history["train_binning"]["n_intersections"] > 0
    assert "memory" not in history  # device figures: the card only

    small = ["--device", "cpu", "--n", "256", "--height", "32", "--width", "32",
             "--iters", "1", "--headline-only"]
    headline = bench.main(small)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json_lines("\n".join(lines)) == [headline] and lines[-1] == json.dumps(headline)
    assert set(headline) == keys - TRAIN_KEYS


def test_no_card_prints_the_error_line_and_does_no_work(monkeypatch, capsys):
    def work(*a, **k):
        raise AssertionError("work began before the device was resolved")

    monkeypatch.setattr(bench, "bench_scene", work)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code == 1
    (line,) = capsys.readouterr().out.strip().splitlines()
    got = json.loads(line)
    assert set(got) == {"metric", "error"} and got["metric"] == bench.METRIC
    assert "no CUDA device" in got["error"]


def test_no_card_cli_exits_1():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m", "tinysplat_torch.scripts.bench"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 1, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[-1])
    assert got["metric"] == "rasterize_fwd_bwd_throughput" and "no CUDA device" in got["error"]
