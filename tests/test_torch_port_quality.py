"""The port's quality tools (``tinysplat_torch/scripts``) against the JAX
package's scripts (``scripts/*.py``, loaded by path and run in this
process on the CPU), part 1: the synthetic quality bench, held-out
evaluation and the 1M-splat probe.

- ``make_gt_scene``: the five arrays bit-equal to the JAX script's.
- ``evaluate``: one JAX checkpoint through both CLIs (JAX ``--rasterizer
  tiled``, the port ``--device cpu``, i.e. the compositing kernel's plain
  version); views and names equal, per-view PSNR within 0.01 dB and SSIM
  within 1e-3. The ``--synthetic`` scene's random rotations are JAX's draw,
  handed over. Where the default budgets drop entries, the port renders the
  frame again at budgets that hold them; JAX scores the truncated frame.
- ``quality_bench``: with ``Trainer`` replaced by a recording stub and the GT
  render by a blank one, both scripts make the same ``run`` calls and
  ``post_opacity_reset`` flags, the same split and Config, and the same JSON
  keys. One GT frame (64x48) of the port's plain kernel against JAX
  ``tiled`` at 2e-4, the suite's image tolerance. A real run of a few steps.
- ``train_1m_probe``: the port's ``_example_state`` equals JAX's
  ``__graft_entry__._example_state``; a small real run prints JAX's keys.

The JAX scripts' checkpoint and cache side effects (``/tmp/
quality_model.npz``, the compile-cache directory) are redirected.
"""
import ast
import contextlib
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from tinysplat_torch.config import Config
from tinysplat_torch.scripts import evaluate, quality_bench, train_1m_probe

from tests.test_torch_port_trainer import _two_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "real_colmap")
IMAGE_TOL = 2e-4  # images (ROADMAP.md, the suite's tolerance)
PSNR_TOL, SSIM_TOL = 0.01, 1e-3


@contextlib.contextmanager
def jax_script(name, monkeypatch=None):
    """The JAX package's ``scripts/<name>.py`` as a module, with scripts/ on
    sys.path for its file imports while the block runs; sys.path and the
    modules imported from scripts/ are put back afterwards. The compile
    cache keeps the suite's directory."""
    saved_path = list(sys.path)
    before = set(sys.modules)
    sys.path.insert(0, SCRIPTS)
    try:
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                      os.path.join(SCRIPTS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if monkeypatch is not None:
            import tinysplat_tpu.utils.cache as cache

            monkeypatch.setattr(cache, "enable_compile_cache", lambda *a, **k: None)
        yield mod
    finally:
        sys.path[:] = saved_path
        for m in set(sys.modules) - before:
            if (getattr(sys.modules[m], "__file__", None) or "").startswith(SCRIPTS):
                del sys.modules[m]


def run_jax_main(mod, argv, capsys, monkeypatch, *args, **kwargs):
    """The JAX script's ``main()`` under ``argv``: its last stdout line."""
    monkeypatch.setattr(sys, "argv", [mod.__name__] + list(argv))
    capsys.readouterr()
    mod.main(*args, **kwargs)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def jax_json_keys(name):
    """The constant keys of the JSON dict literal the JAX script prints (its
    last ``out = {...}``); a key formatted at run time is not among them."""
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    found = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "out" for t in node.targets)):
            found = node.value
    keys = set()
    for k in found.keys:
        if isinstance(k, ast.Constant):
            keys.add(k.value)
    return keys


@pytest.fixture
def tmp_tempdir(tmp_path, monkeypatch):
    """The port's tools write their temporary files under tmp_path."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


# -- make_gt_scene ---------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"n_clusters": 40, "per_cluster": 400}])
def test_make_gt_scene_is_the_jax_scripts(kw):
    with jax_script("quality_bench") as jqb:
        ref = jqb.make_gt_scene(**kw)
    got = quality_bench.make_gt_scene(**kw)
    assert len(got) == 5
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


# -- evaluate ---------------------------------------------------------------------------


def _jax_checkpoint(path, n, scale=0.3, seed=2):
    """A JAX-package checkpoint of ``n`` splats (tests/test_cli.py's shape)."""
    from tinysplat_tpu.io.checkpoint import save_checkpoint
    from tinysplat_tpu.models.gaussians import init_from_pcd

    rng = np.random.default_rng(seed)
    state = init_from_pcd(rng.normal(size=(n, 3)).astype(np.float32) * scale,
                          rng.uniform(0, 255, size=(n, 3)).astype(np.float32),
                          sh_degree=1, capacity=64 * (-(-n // 64)), opacity_init=0.9)
    save_checkpoint(path, state, None, step=10)
    return path


def _hand_over_synthetic_quats(monkeypatch):
    """The port's --synthetic GT scene rotated by JAX's quats draw (the
    packages' random streams differ)."""
    from tinysplat_tpu.data.synthetic import random_gaussian_cloud
    from tinysplat_tpu.models.gaussians import init_from_pcd as jax_init

    import tinysplat_torch.models.gaussians as pg

    means, _, _, colors, _ = random_gaussian_cloud(400, seed=7)
    quats = np.asarray(jax_init(means, colors * 255, sh_degree=1, capacity=512).params.quats)
    real = pg.init_from_pcd

    def init_from_pcd(xyz, *a, **k):
        if len(xyz) == 400 and k.get("quats") is None:
            k["quats"] = quats[:400]
        return real(xyz, *a, **k)

    monkeypatch.setattr(pg, "init_from_pcd", init_from_pcd)


@pytest.mark.parametrize("case", ["synthetic", "real_colmap"])
def test_evaluate_matches_jax(case, tmp_path, capsys, monkeypatch):
    ck = _jax_checkpoint(str(tmp_path / "model.npz"), 60)
    flags = (["--synthetic", "--max-views", "2"] if case == "synthetic"
             else ["--dataset-dir", FIXTURE, "--holdout", "4"])
    if case == "synthetic":
        _hand_over_synthetic_quats(monkeypatch)
    with jax_script("evaluate", monkeypatch) as jev:
        ref = run_jax_main(jev, [ck] + flags + ["--rasterizer", "tiled"], capsys, monkeypatch)
    got = evaluate.main([ck] + flags + ["--device", "cpu"])
    assert set(got) == set(ref) == {"checkpoint", "views", "psnr", "ssim", "per_view"}
    assert got["views"] == ref["views"] == 2
    assert [v["name"] for v in got["per_view"]] == [v["name"] for v in ref["per_view"]]
    for g, r in zip(got["per_view"], ref["per_view"]):
        assert abs(g["psnr"] - r["psnr"]) <= PSNR_TOL, (g, r)
        assert abs(g["ssim"] - r["ssim"]) <= SSIM_TOL, (g, r)
    assert 5 < got["psnr"] < 60


def test_evaluate_renders_a_truncated_frame_again(tmp_path, caplog):
    """400 large splats at 239x179: the default budgets (8 x 1024 entries)
    drop entries; the port scores the whole model, as a render at budgets
    that hold every entry does."""
    from tinysplat_torch.data.dataset import Dataset
    from tinysplat_torch.io.checkpoint import load_model
    from tinysplat_torch.ops.ssim import psnr
    from tinysplat_torch.render import render

    ck = _jax_checkpoint(str(tmp_path / "model.npz"), 400, scale=0.6)
    got = evaluate.main([ck, "--dataset-dir", FIXTURE, "--holdout", "4", "--device", "cpu"])
    assert "default budgets dropped" in caplog.text
    state = load_model(ck, device="cpu")
    cams = Dataset(os.path.join(FIXTURE, "sparse", "0"), os.path.join(FIXTURE, "images"))
    for view, cam in zip(got["per_view"], cams.cameras[::4]):
        rgb, ex = render(state.params, state.alive, cam.params("cpu"), cam.height, cam.width,
                         state.active_sh_degree, torch.zeros(3), dup_capacity=1 << 20,
                         span_capacity=1 << 20, max_per_tile=16384)
        assert int(ex["binning"]["dup_dropped"]) == int(ex["binning"]["tile_dropped"]) == 0
        gt = torch.as_tensor(cam.get_original_image((cam.width, cam.height)))
        assert view["psnr"] == round(float(psnr(rgb, gt)), 3)


# -- quality_bench ------------------------------------------------------------------------

TINY = ["--width", "64", "--height", "48", "--cameras", "6", "--holdout", "3",
        "--init-points", "200", "--capacity", "512"]


def _recording_trainer(log, xp):
    """A ``Trainer`` stand-in that records what the script asks of it;
    ``xp`` makes its arrays (jnp or torch)."""

    class RecordingTrainer:
        def __init__(self, cfg, scene, state, *args, **kwargs):
            self.cfg, self.scene, self.state = cfg, scene, state
            self.step, self._image_cache, self.eval_cameras = 0, {}, []
            self.calls = []
            log.append(self)

        def run(self, max_iter=None):
            self.calls.append(max_iter)
            self.step = max_iter

        def evaluate(self, cameras=None):
            return {"eval_psnr": 20.0 + self.step / 1000, "eval_ssim": 0.5}

        def render_camera(self, camera, dims=None, background=None):
            return xp.zeros((camera.height, camera.width, 3)), {}

    return RecordingTrainer


def _blank_render(xp):
    def render(params, alive, cam, h, w, *args, **kwargs):
        zero = xp.zeros(())
        return xp.zeros((h, w, 3)), {"depth": xp.zeros((h, w)),
                                    "binning": {"dup_dropped": zero, "tile_dropped": zero}}

    return render


def test_quality_bench_schedule_split_and_config_match_jax(capsys, monkeypatch, tmp_tempdir):
    """Both scripts with the trainer and the GT render stubbed, on a
    schedule whose eval at 3000 lands on the opacity reset (every 3000,
    inside densify_end 4666): that eval moves to 3500 and is marked."""
    import tinysplat_tpu.io.checkpoint as jck
    import tinysplat_tpu.train_loop as jtl

    jrender = sys.modules["tinysplat_tpu.render"]  # the package exports its function

    flags = TINY + ["--iters", "7000", "--eval-every", "1000"]
    saved, jlog, plog = [], [], []
    monkeypatch.setattr(jtl, "Trainer", _recording_trainer(jlog, jnp))
    monkeypatch.setattr(jrender, "render", _blank_render(jnp))
    monkeypatch.setattr(jck, "save_checkpoint", lambda path, *a, **k: saved.append(path))
    with jax_script("quality_bench", monkeypatch) as jqb:
        ref = run_jax_main(jqb, flags, capsys, monkeypatch)
    monkeypatch.setattr(quality_bench, "Trainer", _recording_trainer(plog, torch))
    monkeypatch.setattr(quality_bench, "render", _blank_render(torch))
    got = quality_bench.main(flags + ["--device", "cpu"])
    (jt,), (pt,) = jlog, plog
    assert saved == ["/tmp/quality_model.npz"]
    assert (tmp_tempdir / "quality_model.npz").exists()
    assert pt.calls == jt.calls == [1000, 2000, 3500, 4500, 5500, 6500, 7000]
    marks = [e.get("post_opacity_reset", False) for e in got["eval_history"]]
    assert marks == [e.get("post_opacity_reset", False) for e in ref["eval_history"]]
    assert marks == [False, False, True, False, False, False, False]
    assert [c.name for c in pt.scene.cameras] == [c.name for c in jt.scene.cameras]
    assert [c.name for c in pt.eval_cameras] == [c.name for c in jt.eval_cameras]
    assert len(pt.scene.cameras) == 4 and len(pt.eval_cameras) == 2
    assert sorted(pt._image_cache) == sorted(jt._image_cache)
    # The port's own option at its default.
    assert dataclasses.asdict(pt.cfg) == dict(dataclasses.asdict(jt.cfg), mcmc_refine_every=0)
    assert set(got) == set(ref)
    varying = ("eval_history", "steps_per_s", "train_minutes", "gt_rasterizer")
    assert {k: v for k, v in got.items() if k not in varying} == \
        {k: v for k, v in ref.items() if k not in varying}
    assert (got["gt_rasterizer"], ref["gt_rasterizer"]) == ("cuda", "tiled")


@pytest.mark.parametrize("iters,every,mcmc,want,marked", [
    (3500, 500, False, [500, 1000, 1500, 2000, 2500, 3000, 3500], []),  # 3000 > densify_end
    (7000, 500, False, [500, 1000, 1500, 2000, 2500, 3300, 3800, 4300, 4800, 5300, 5800,
                        6300, 6800, 7000], [3300]),
    (7000, 1000, True, [1000, 2000, 3000, 4000, 5000, 6000, 7000], []),  # MCMC: no reset
    (3000, 1000, False, [1000, 2000, 3000], []),  # 3000 > densify_end 2000
])
def test_quality_bench_eval_boundaries(iters, every, mcmc, want, marked):
    cfg = Config(max_iter=iters, densify_end=iters * 10 // 15)
    step, got, marks = 0, [], []
    while step < iters:
        step, post = quality_bench.eval_boundaries(step, iters, every,
                                                   cfg.interval_opacity_reset,
                                                   cfg.densify_end, mcmc)
        got.append(step)
        if post:
            marks.append(step)
    assert got == want and marks == marked


def _f64_composite(state, cam, h, w, pixels):
    """The frame at ``pixels`` ((y, x) pairs) composited in float64 from the
    port's projected splats: every splat at each pixel, depth order (the
    dense oracle's definition, without its (pixels x splats) float32 arrays
    over the whole frame)."""
    import importlib

    from tinysplat_torch.render import splat_inputs

    rd = importlib.import_module("tinysplat_torch.ops.rasterize_dense")
    s = splat_inputs(state.params, state.alive, cam.params("cpu"), h, w, 3, torch.zeros(3))
    px = torch.tensor([[float(x), float(y)] for y, x in pixels], dtype=torch.float64)
    order = rd.sort_by_depth(s.proj.depths, s.valid)
    alpha = rd.alpha_matrix(px, s.xys[order].double(), s.proj.conics[order].double(),
                            s.opacities[order].double(), s.valid[order])
    out, _ = rd.composite(alpha, s.colors4[order].double(), torch.zeros(4, dtype=torch.float64))
    return out[:, :3].numpy()


def test_quality_bench_gt_frame_matches_jax_tiled():
    """GT view 1 at 64x48 (tiles ~20,000 entries deep, hence the 65536
    per-tile budget): the port's GT path (plain kernel) against the JAX
    script's (XLA tiled) at the script's other budgets, to 2e-4. Where the
    two differ by more (2 pixels, 2.9e-4, in this view), the port must be
    the one that agrees with the float64 composite of the same splats."""
    from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
    from tinysplat_tpu.models.gaussians import init_from_pcd as jax_init
    from tinysplat_tpu.render import render as jax_render

    from tinysplat_torch.data.synthetic import orbit_cameras

    H, W, MPT = 48, 64, 65536
    means, log_scales, quats, colors, opac = quality_bench.make_gt_scene()
    gs = jax_init(means, colors * 255.0, sh_degree=3, capacity=len(means))
    gs = dataclasses.replace(gs, params=dataclasses.replace(
        gs.params, scales=jnp.asarray(log_scales), quats=jnp.asarray(quats),
        opacities=jnp.asarray(opac)))
    jcam = jax_orbit_cameras(6, width=W, height=H, radius=3.2, fov=0.9)[1]
    ref, ex = jax.jit(lambda cp: jax_render(
        gs.params, gs.alive, cp, H, W, active_sh_degree=jnp.int32(3),
        background=jnp.zeros(3), rasterizer="tiled", dup_capacity=6_000_000,
        max_per_tile=MPT, span_capacity=2_000_000))(jcam.params())
    assert int(ex["binning"]["dup_dropped"]) + int(ex["binning"]["tile_dropped"]) == 0
    ref = np.asarray(ref)

    state = quality_bench.make_gt_state(means, log_scales, quats, colors, opac, 3, "cpu")
    render_gt = quality_bench.gt_renderer(
        state, 3, "cuda", dup_capacity=quality_bench.GT_DUP_CAPACITY, max_per_tile=MPT,
        span_capacity=quality_bench.GT_SPAN_CAPACITY)
    cam = orbit_cameras(6, width=W, height=H, radius=3.2, fov=0.9)[1]
    got, depth, dropped = render_gt(cam.params("cpu"), H, W)
    got = got.numpy()
    assert dropped == 0 and depth.shape == (H, W)
    assert float(got.mean()) > 0.1  # the dome covers the frame
    off = np.argwhere(np.abs(got - ref).max(-1) > IMAGE_TOL)
    assert len(off) <= 4, off
    if len(off):
        exact = _f64_composite(state, cam, H, W, off)
        port = got[off[:, 0], off[:, 1]]
        jax_ = ref[off[:, 0], off[:, 1]]
        np.testing.assert_allclose(port, exact, atol=1e-5, rtol=0)
        assert (np.abs(jax_ - exact).max(-1) > IMAGE_TOL).all()
    mask = np.ones((H, W), bool)
    mask[off[:, 0], off[:, 1]] = False
    np.testing.assert_allclose(got[mask], ref[mask], atol=IMAGE_TOL, rtol=0)


def test_quality_bench_runs_on_the_cpu(tmp_tempdir):
    """A real port run: 2 cameras at 32x16 (1 train / 1 eval), GT from the
    dense oracle (the plain kernel walks ~37,000 entries a tile at this
    size), 6 steps, a held-out eval every 3 and at half scale."""
    out_path = tmp_tempdir / "q.json"
    got = quality_bench.main(
        ["--device", "cpu", "--iters", "6", "--width", "32", "--height", "16",
         "--cameras", "2", "--holdout", "2", "--init-points", "200", "--capacity", "512",
         "--eval-every", "3", "--gt-rasterizer", "dense", "--eval-scales", "0.5",
         "--out", str(out_path)])
    # The optional key and the one formatted from --target-psnr.
    assert set(got) == jax_json_keys("quality_bench") | {"multiscale_psnr", "minutes_to_27dB"}
    assert json.loads(out_path.read_text()) == got
    assert [e["step"] for e in got["eval_history"]] == [3, 6]
    assert (got["train_cameras"], got["eval_cameras"]) == (1, 1)
    assert set(got["multiscale_psnr"]) == {"0.5x"}
    assert all(np.isfinite(e["psnr"]) for e in got["eval_history"])
    assert np.isfinite(got["value"]) and got["gt_rasterizer"] == "dense"
    assert (tmp_tempdir / "quality_model.npz").exists()


# -- train_1m_probe -------------------------------------------------------------------------


def test_example_state_matches_graft_entry():
    saved = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("jax_graft_entry",
                                                  os.path.join(REPO, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(graft)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    for cap in (300, 384):
        ref = graft._example_state(n=300, capacity=cap, scale_range=(0.002, 0.008))
        got = train_1m_probe._example_state(300, cap, scale_range=(0.002, 0.008),
                                            device="cpu")
        for name in ("means", "colors_dc", "colors_rest", "scales", "quats", "opacities"):
            np.testing.assert_array_equal(getattr(got.params, name).numpy(),
                                          np.asarray(getattr(ref.params, name)), err_msg=name)
        np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
        assert int(got.active_sh_degree) == int(ref.active_sh_degree)


def test_train_1m_probe_runs_on_the_cpu(tmp_path):
    out = tmp_path / "p.json"
    got = train_1m_probe.main(["--device", "cpu", "--n", "2000", "--steps", "2",
                               "--height", "48", "--width", "64", "--cameras", "2",
                               "--out", str(out)])
    assert set(got) == jax_json_keys("train_1m_probe")
    assert json.loads(out.read_text()) == got
    assert got["gt_dropped"] == 0 and got["n_splats"] == 2000 and got["steps"] == 2
    assert np.isfinite(got["psnr_start"]) and np.isfinite(got["psnr_end"])
    assert set(got["tuned_budgets"]) == {"dup_capacity", "span_capacity", "max_per_tile"}


def test_train_1m_probe_means_jitter_is_handed_over():
    """JAX draws the jitter from PRNGKey(7); handed over, the trainee's
    means are JAX's."""
    n = 300
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (n, 3)))
    state = train_1m_probe._example_state(n, n, scale_range=(0.002, 0.008), device="cpu")
    ref = state.params.means.numpy() + 0.003 * noise
    captured = {}

    class Stop(Exception):
        pass

    def capture(cfg, scene, st, *a, **k):
        captured["means"] = st.params.means.clone()
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_1m_probe, "Trainer", capture)
        with pytest.raises(Stop):
            train_1m_probe.main(["--device", "cpu", "--n", str(n), "--height", "16",
                                 "--width", "16", "--cameras", "1"],
                                noise=torch.as_tensor(np.array(noise)))
    np.testing.assert_allclose(captured["means"].numpy(), ref, rtol=0, atol=1e-7)
