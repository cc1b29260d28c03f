"""The port's profiling, sweep and scaling tools (``tinysplat_torch/scripts``:
``profile_bench``, ``profile_train_step``, ``sweep_bench``, ``scaling_bench``,
``scaling_model``) against the JAX package's scripts of the same names.

- ``sweep_bench --diag``: the binning counters of the bench scene (4,096
  splats at 64x96, the JAX ``_example_state`` carried across) equal the JAX
  ``render``'s ``extras["binning"]`` exactly, at 16-px tiles (JAX
  ``tiled``) and 64-px ones (JAX ``pallas``: ``tiled`` has no tile width).
- ``scaling_bench``: part 1's per-band intersections (contiguous and
  interleaved, 4 bands, 2 orbit views at 128x128 of the GT scene at 4 x 60)
  equal the JAX script's ``project_gaussians`` + ``bin_splats_dense``
  exactly; part 2 runs on 4 gloo CPU ranks at 64x64 and prints JAX's keys.
- ``scaling_model.predict`` reproduces ``SCALING_r05.json``'s ``predicted``
  from its ``measured_on_chip`` at the record's 400 GB/s link.
- ``profile_bench`` / ``profile_train_step`` print their table on the CPU
  (2,048 splats at 64x96, one iteration); the top-ops table's self times
  equal ``key_averages()``'s.
- Every tool's flags are its JAX script's plus ``--device``, with the JAX
  defaults but for the output paths and the link figure; with no card the
  default device raises before any work.
"""
import argparse
import contextlib
import functools
import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.models.gaussians import from_jax_params
from tinysplat_torch.scripts import (
    profile_bench, profile_train_step, quality_bench, scaling_bench, scaling_model, sweep_bench)
from tinysplat_torch.utils import profiling

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_port_trainer import leaves_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"profile_bench": profile_bench, "profile_train_step": profile_train_step,
         "sweep_bench": sweep_bench, "scaling_bench": scaling_bench,
         "scaling_model": scaling_model}
# Defaults the port owns: where the tools write, and the link of the card's machine.
PORT_DEFAULTS = {"logdir", "out", "ici_gbps"}


@contextlib.contextmanager
def jax_script(name, monkeypatch):
    """``scripts/<name>.py`` loaded by path, its import-time side effects
    (the compile-cache switch, the environment, sys.path) kept out."""
    import tinysplat_tpu.utils.cache as cache

    saved_path = list(sys.path)
    monkeypatch.setattr(cache, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(os, "environ", dict(os.environ))
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tool_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield mod
    finally:
        sys.path[:] = saved_path


class _Parsed(Exception):
    pass


def jax_parser(name, monkeypatch) -> argparse.ArgumentParser:
    """The parser the JAX script's ``main`` builds (stopped at parse_args)."""
    seen = {}

    def parse_args(self, *a, **k):
        seen["parser"] = self
        raise _Parsed

    with jax_script(name, monkeypatch) as mod:
        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Parsed):
            mod.main()
    monkeypatch.undo()
    return seen["parser"]


def flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, a.choices,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_flags_are_the_jax_scripts_plus_device(name, monkeypatch):
    ours = flags(TOOLS[name].arg_parser())
    theirs = flags(jax_parser(name, monkeypatch))
    assert ours.pop("device")[:2] == (("--device",), "cuda")
    assert ours.keys() == theirs.keys()
    for dest, (opts, default, typ, nargs, choices, kind) in theirs.items():
        got = ours[dest]
        assert got[0] == opts and got[2:] == (typ, nargs, choices, kind), dest
        if dest not in PORT_DEFAULTS:
            assert got[1] == default, dest
        else:
            assert got[1] != default, dest  # never the JAX run's file or the v5e link


def test_output_defaults_are_the_ports_own():
    assert scaling_bench.arg_parser().get_default("out") not in ("SCALING_r03.json",
                                                                 "SCALING_r05.json")
    assert scaling_model.arg_parser().get_default("out") not in ("SCALING_r03.json",
                                                                 "SCALING_r05.json")
    for mod in (profile_bench, profile_train_step):
        assert mod.arg_parser().get_default("logdir") is None  # tempdir/tinysplat_torch_trace*
    assert scaling_model.arg_parser().get_default("ici_gbps") == 900.0


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_no_cpu_fallback(name, monkeypatch):
    mod = TOOLS[name]

    def work(*a, **k):
        raise AssertionError("work began before the device was resolved")

    for attr in ("bench_scene", "_example_state", "make_gt_scene"):
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, work)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


# -- sweep_bench --diag vs the JAX render's binning counters ----------------------------

@functools.cache
def jax_bench_state(n):
    import __graft_entry__

    return __graft_entry__._example_state(n=n, capacity=n, scale_range=(0.002, 0.01))


@pytest.mark.parametrize("tile_x,backend", [(16, "tiled"), (64, "pallas")])
def test_sweep_diag_equals_jax_binning(tile_x, backend, monkeypatch):
    from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit
    from tinysplat_tpu.render import render as jax_render

    n, H, W = 4096, 64, 96
    jst = jax_bench_state(n)
    carried = from_jax_params(leaves_of(jst), "cpu")
    monkeypatch.setattr(sweep_bench, "bench_scene", lambda n_, h, w, dev: (
        carried, orbit_cameras(1, width=w, height=h)[0].params(dev), torch.zeros(3)))
    (line,) = sweep_bench.main(["--device", "cpu", "--n", str(n), "--height", str(H),
                                "--width", str(W), "--diag", "--configs",
                                f"scatter:8:128:{tile_x}"])
    assert line["tiles_per_block_read"] is False and "error" not in line

    cam = jax_orbit(1, width=W, height=H)[0].params()
    diag = jax.jit(lambda p: jax_render(
        p, jst.alive, cam, H, W, active_sh_degree=jnp.int32(3), background=jnp.zeros(3),
        rasterizer=backend, dup_capacity=1_280_000, span_capacity=786_432,
        max_per_tile=4096, tile_x=tile_x)[1]["binning"])(jst.params)
    want = {k: int(v) for k, v in jax.device_get(diag).items()}
    assert line["diag"] == want and want["intersections"] > 0


def test_sweep_error_lines_keep_going(capsys):
    lines = sweep_bench.main(["--device", "cpu", "--n", "256", "--height", "32", "--width",
                              "32", "--diag", "--configs", "nope:8:128", "scatter:8:128"])
    assert lines[0]["error"].startswith("grad_reduce must be one of")
    assert lines[1]["diag"]["intersections"] > 0
    printed = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert printed == lines and all(x["tiles_per_block_read"] is False for x in lines)


# -- scaling_bench ----------------------------------------------------------------------

def jax_band_counts(scene, cams, H, W, n_tile):
    """scripts/scaling_bench.py:77-113 on ``scene``."""
    import dataclasses

    from tinysplat_tpu.models.gaussians import init_from_pcd
    from tinysplat_tpu.ops.binning import bin_splats_dense
    from tinysplat_tpu.ops.projection import project_gaussians

    means, log_scales, quats, colors, opac = scene
    n, Hl = len(means), H // n_tile
    st = init_from_pcd(means, colors * 255.0, sh_degree=1, capacity=n)
    st = dataclasses.replace(st, params=dataclasses.replace(
        st.params, scales=jnp.asarray(log_scales), quats=jnp.asarray(quats),
        opacities=jnp.asarray(opac)))

    @jax.jit
    def band_counts(cam):
        proj = project_gaussians(
            means=st.params.means, scales=jnp.exp(st.params.scales), glob_scale=1.0,
            quats=st.params.quats, viewmat=cam.viewmat,
            full_projmat=cam.projmat @ cam.viewmat, fx=cam.fx, fy=cam.fy, cx=W / 2.0,
            cy=H / 2.0, img_height=H, img_width=W, tile_size=16)
        opacs = jax.nn.sigmoid(st.params.opacities.reshape(-1))
        contig, inter = [], []
        for b in range(n_tile):
            shift = jnp.asarray([0.0, b * Hl], jnp.float32)
            contig.append(bin_splats_dense(
                proj.xys - shift, proj.depths, proj.radii, proj.valid & st.alive, W // 16,
                Hl // 16, 16, dup_capacity=16 * n, conics=proj.conics,
                opacities=opacs).total_intersections)
            inter.append(bin_splats_dense(
                proj.xys, proj.depths, proj.radii, proj.valid & st.alive, W // 16, Hl // 16,
                16, dup_capacity=16 * n, conics=proj.conics, opacities=opacs,
                row_stride=n_tile, row_offset=b).total_intersections)
        return jnp.stack(contig), jnp.stack(inter)

    return [tuple(np.asarray(x).tolist() for x in jax.device_get(band_counts(c.params())))
            for c in cams]


def test_scaling_bench_band_counts_equal_jax():
    from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit

    H = W = 128
    scene = quality_bench.make_gt_scene(n_clusters=4, per_cluster=60, seed=0)
    state = quality_bench.make_gt_state(*scene, 1, "cpu")
    cams = orbit_cameras(2, width=W, height=H, radius=3.2, fov=0.9)
    with torch.no_grad():
        ours = [scaling_bench.band_counts(state, c.params("cpu"), H, W, 4) for c in cams]
    want = jax_band_counts(scene, jax_orbit(2, width=W, height=H, radius=3.2, fov=0.9), H, W, 4)
    assert [tuple(map(list, x)) for x in ours] == [tuple(map(list, x)) for x in want]
    assert all(sum(c) > 0 and sum(i) > 0 for c, i in ours)
    mean, mx, ratio = scaling_bench.spread([c for c, _ in ours])
    per_band = np.asarray([c for c, _ in want], np.float64)
    assert (mean, mx) == (float(per_band.mean()), float(per_band.max(axis=1).mean()))
    assert ratio == mx / max(mean, 1.0)


def test_scaling_bench_runs_on_cpu_ranks(tmp_path, monkeypatch):
    scene = functools.partial(quality_bench.make_gt_scene, n_clusters=4, per_cluster=60)
    monkeypatch.setattr(scaling_bench, "make_gt_scene", lambda **kw: scene(seed=kw["seed"]))
    monkeypatch.setattr(scaling_bench, "STEP_POINTS", 1024)
    out_path = tmp_path / "scaling.json"
    history = {}
    out = scaling_bench.main(["--device", "cpu", "--devices", "4", "--width", "64", "--height",
                              "64", "--cameras", "2", "--out", str(out_path)], history=history)
    with open(os.path.join(REPO, "SCALING_r03.json")) as f:
        jax_keys = set(json.load(f))
    assert set(out) == jax_keys and json.loads(out_path.read_text()) == out
    assert out["mesh"] == [1, 4] and len(history["ranks"]) == 4
    assert math.isfinite(out["sharded_work_overhead"]) and out["sharded_work_overhead"] > 0
    assert "timeshare one CPU" in out["note_overhead"]


# -- scaling_model.predict ----------------------------------------------------------------

def test_scaling_model_predict_reproduces_the_jax_record():
    with open(os.path.join(REPO, "SCALING_r05.json")) as f:
        rec = json.load(f)
    m = rec["measured_on_chip"]
    pred, value = scaling_model.predict(
        m["t_plain_ms"], {int(t): v for t, v in m["t_grad_band_ms"].items()},
        {int(t): v for t, v in m["t_overhead_ms"].items()}, rec["n_splats"], 3, 400.0,
        *rec["resolution"])
    want = rec["predicted"]
    assert pred.keys() == want.keys() and value == rec["value"] == 0.929
    for mesh, w in want.items():
        got = pred[mesh]
        assert got["chips"] == w["chips"]
        assert abs(got["t_coll_ms"] - w["t_coll_ms"]) <= 1e-4, mesh
        assert abs(got["t_step_ms"] - w["t_step_ms"]) <= 0.011, mesh
        assert abs(got["rays_per_s"] / w["rays_per_s"] - 1) <= 1e-3, mesh
        assert abs(got["efficiency_vs_1chip"] - w["efficiency_vs_1chip"]) <= 0.0011, mesh


# -- the profiling tools -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["profile_bench", "profile_train_step"])
def test_profile_tool_prints_its_table_on_the_cpu(name, tmp_path, capsys):
    out = TOOLS[name].main(["--device", "cpu", "--n", "2048", "--height", "64", "--width",
                            "96", "--iters", "1", "--top", "12", "--logdir",
                            str(tmp_path / "trace")])
    printed = capsys.readouterr().out
    assert out["line"] == "CPU ops, self time" and len(out["rows"]) == 12
    assert out["lines"][0].split()[:3] == ["ms/iter", "count", "op"]
    assert all(text in printed for text in out["lines"])
    assert out["kernel_busy_share"] is None and "no device trace" in printed
    assert 0 < out["rows"][0][1] <= out["total_ms_per_iter"]
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    if name == "profile_bench":
        assert out["binning"]["intersections"] > 0
        assert "binning of the profiled render" in printed
    else:
        assert math.isfinite(out["loss"])


def test_top_ops_self_time_equals_key_averages():
    x = torch.randn(64, 64)

    def work():
        with torch.profiler.record_function("outer"):  # a CPU annotation is a row
            y = torch.nn.functional.softmax(x @ x, dim=-1)  # nested aten ops
            return (y * 2 + 1).sum() + x.sum(0).mean()  # sum nests an aten::sum

    prof = profiling.window(work, 3, "cpu")
    line, agg = profiling.top_ops(prof)
    want = {e.key: (e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()}
    assert line == "CPU ops, self time" and agg.keys() == want.keys()
    for op, (ms, count) in want.items():
        assert agg[op][1] == count and agg[op][0] == pytest.approx(ms, abs=1e-6), op
    assert profiling.kernel_busy_share(prof) is None


def test_trainer_shares_the_profiling_code():
    from tinysplat_torch import train_loop

    assert train_loop.kernel_busy_share is profiling.kernel_busy_share
    assert profiling.time_key("cuda") == "device_time_total"
    assert profiling.time_key("cpu") == "cpu_time_total"
