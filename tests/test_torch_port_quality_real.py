"""The port's quality tools against the JAX package's scripts, part 2: the
real-photo capture (``make_real_fixture``) and the real-capture benchmark
(``quality_real``), on the CPU.

- ``make_real_fixture`` at a tiny size (3 views, 64x48): ``cameras.bin``,
  ``images.bin``, ``points3D.bin`` and the JPEGs byte-identical to the JAX
  script's (a fresh module each, as its draws are module state there).
- ``quality_real`` on copies of tests/fixtures/real_colmap (one per
  package, so that neither reads the other's depth cache), with ``Trainer``
  replaced by a recording stub: the same train / eval split, ``sparse_interp``
  depth maps bit-equal, the same Config and ``run`` calls. A real port run of
  4 steps prints the JSON line with the JAX script's keys, and the fixture
  itself gains no file.
"""
import dataclasses
import filecmp
import os
import shutil

import jax.numpy as jnp
import numpy as np
import torch

from tinysplat_torch.scripts import make_real_fixture, quality_real

from tests.test_torch_port_quality import (
    FIXTURE, _recording_trainer, jax_json_keys, jax_script, run_jax_main)
from tests.test_torch_port_trainer import _two_torch_threads  # noqa: F401 (autouse)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_make_real_fixture_writes_the_jax_scripts_bytes(tmp_path):
    kw = dict(n_views=3, width=64, height=48, per_plane=20)
    with jax_script("make_real_fixture") as jmrf:
        jmrf.main(out_root=str(tmp_path / "jax"), **kw)
    make_real_fixture.main(out_root=str(tmp_path / "port"), **kw)
    files = _tree(tmp_path / "jax")
    assert files == _tree(tmp_path / "port") == [
        "images/view_00.jpg", "images/view_01.jpg", "images/view_02.jpg",
        "sparse/0/cameras.bin", "sparse/0/images.bin", "sparse/0/points3D.bin"]
    for f in files:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False), f
    # A second capture draws the same points (the JAX script's RNG is module
    # state: only its first call in a process gives these bytes).
    make_real_fixture.main(out_root=str(tmp_path / "again"), **kw)
    assert filecmp.cmp(tmp_path / "port/sparse/0/points3D.bin",
                       tmp_path / "again/sparse/0/points3D.bin", shallow=False)


def test_quality_real_split_depth_and_config_match_jax(tmp_path, capsys, monkeypatch):
    import tinysplat_tpu.train_loop as jtl

    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(FIXTURE, jdir)
    shutil.copytree(FIXTURE, pdir)
    flags = ["--holdout", "4", "--iters", "300", "--eval-every", "100"]
    jlog, plog = [], []
    monkeypatch.setattr(jtl, "Trainer", _recording_trainer(jlog, jnp))
    with jax_script("quality_real", monkeypatch) as jqr:
        ref = run_jax_main(jqr, flags + ["--scene-dir", str(jdir)], capsys, monkeypatch)
    monkeypatch.setattr(quality_real, "Trainer", _recording_trainer(plog, torch))
    got = quality_real.main(flags + ["--scene-dir", str(pdir), "--device", "cpu"])
    (jt,), (pt,) = jlog, plog
    assert pt.calls == jt.calls == [100, 200, 300]
    assert [c.name for c in pt.scene.cameras] == [c.name for c in jt.scene.cameras] == [
        "view_01.jpg", "view_02.jpg", "view_03.jpg", "view_05.jpg", "view_06.jpg",
        "view_07.jpg"]
    assert [c.name for c in pt.eval_cameras] == [c.name for c in jt.eval_cameras] == [
        "view_00.jpg", "view_04.jpg"]
    for pc, jc in zip(pt.scene.cameras, jt.scene.cameras):
        assert pc.estimated_depth.shape == (pc.height, pc.width)
        np.testing.assert_array_equal(pc.estimated_depth, jc.estimated_depth)
    assert sorted(os.listdir(pdir / "depths")) == sorted(os.listdir(jdir / "depths"))
    # The port's own option at its default.
    assert dataclasses.asdict(pt.cfg) == dict(dataclasses.asdict(jt.cfg), mcmc_refine_every=0)
    assert pt.cfg.background == "black" and pt.cfg.regularize_depth
    np.testing.assert_array_equal(pt.state.params.means.numpy(),
                                  np.asarray(jt.state.params.means))
    assert set(got) == set(ref) == jax_json_keys("quality_real")
    varying = ("eval_history", "steps_per_s", "train_minutes")
    assert {k: v for k, v in got.items() if k not in varying} == \
        {k: v for k, v in ref.items() if k not in varying}


def test_quality_real_runs_on_a_copy_of_the_fixture(tmp_path):
    before = _tree(FIXTURE)
    scene = tmp_path / "scene"
    shutil.copytree(FIXTURE, scene)
    out = tmp_path / "q.json"
    got = quality_real.main(["--device", "cpu", "--scene-dir", str(scene), "--holdout", "4",
                             "--iters", "4", "--eval-every", "2", "--out", str(out)])
    assert set(got) == jax_json_keys("quality_real")
    assert [e["step"] for e in got["eval_history"]] == [2, 4]
    assert all(np.isfinite(e["psnr"]) for e in got["eval_history"])
    assert got["views"] == 8 and got["depth_reg"] and got["num_splats"] > 0
    assert len(os.listdir(scene / "depths")) == 6
    assert _tree(FIXTURE) == before
