"""Port vs JAX package end to end: ``render``, state and checkpoints (CPU).

A few hundred splats at 64x64 with SH degree 3, weights carried across by
``from_jax_params``; rgb, depth and alpha to 2e-4 (the reference suite's
image tolerance). The port's default backend (K1's plain version on CPU
tensors) is held against the JAX 'tiled' backend and the port's dense
oracle against the JAX dense oracle.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.data.synthetic import random_gaussian_cloud, synthetic_pcd
from tinysplat_tpu.io.checkpoint import load_model as jax_load_model
from tinysplat_tpu.io.checkpoint import save_checkpoint
from tinysplat_tpu.models import gaussians as jg
from tinysplat_tpu.render import render as jax_render

import tinysplat_torch as tt
from tinysplat_torch.data.synthetic import orbit_cameras

from tests._torch_threads import one_torch_thread  # noqa: F401

H = W = 64
N = 300
FIELDS = ("means", "colors_dc", "colors_rest", "scales", "quats", "opacities")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(n=N, seed=11, capacity=None):
    """A JAX GaussianState (SH degree 3, some dead slots) + its numpy leaves."""
    means, log_scales, quats, colors, opac = random_gaussian_cloud(
        n, seed=seed, scale_range=(0.02, 0.1))
    rng = np.random.default_rng(seed)
    capacity = capacity or n + 20

    def pad(a, fill):
        out = np.full((capacity,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out

    quats_p = pad(quats, 0.0)
    quats_p[n:, 0] = 1.0
    leaves = {
        "means": pad(means, 0.0),
        "colors_dc": pad((colors - 0.5) / 0.28209479177387814, 0.0),
        "colors_rest": pad((rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32), 0.0),
        "scales": pad(log_scales, -10.0),
        "quats": quats_p,
        "opacities": pad(opac, -20.0),
        "alive": np.arange(capacity) < n,
        "active_sh_degree": np.int32(3),
    }
    state = jg.GaussianState(
        params=jg.GaussianParams(**{k: jnp.asarray(leaves[k]) for k in FIELDS}),
        alive=jnp.asarray(leaves["alive"]),
        means_grad_accum=jnp.zeros((capacity,), jnp.float32),
        active_sh_degree=jnp.int32(3),
    )
    return state, leaves


def _render_both(jax_backend, port_backend, cam_index=1, active=3, **kw):
    state, leaves = _scene()
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)
    jcam = jax_orbit_cameras(3, width=W, height=H)[cam_index]
    rgb_j, ex_j = jax_render(state.params, state.alive, jcam.params(), H, W,
                             jnp.int32(active), jnp.asarray(bg),
                             rasterizer=jax_backend, **kw)
    ts = tt.from_jax_params(leaves, "cpu")
    tcam = orbit_cameras(3, width=W, height=H)[cam_index].params(device="cpu")
    rgb_t, ex_t = tt.render(ts.params, ts.alive, tcam, H, W, active,
                            torch.from_numpy(bg), rasterizer=port_backend, **kw)
    return (rgb_j, ex_j), (rgb_t, ex_t)


def _assert_frames_close(ref, got, atol=2e-4):
    (rgb_j, ex_j), (rgb_t, ex_t) = ref, got
    assert rgb_t.shape == (H, W, 3)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=atol)
    for key in ("depth", "alpha"):
        np.testing.assert_allclose(ex_t[key].numpy(), np.asarray(ex_j[key]),
                                   atol=atol, err_msg=key)
    np.testing.assert_array_equal(ex_t["radii"].numpy(), np.asarray(ex_j["radii"]))
    np.testing.assert_allclose(ex_t["xys"].numpy(), np.asarray(ex_j["xys"]),
                               atol=1e-4, rtol=1e-5)
    assert float(ex_t["alpha"].max()) > 0.5  # the frame is not empty


@pytest.mark.parametrize("jax_backend,port_backend",
                         [("tiled", "auto"), ("dense", "dense")])
@pytest.mark.parametrize("viewdirs_mode", ["reference", "position"])
def test_render_matches_jax(jax_backend, port_backend, viewdirs_mode):
    ref, got = _render_both(jax_backend, port_backend, viewdirs_mode=viewdirs_mode)
    _assert_frames_close(ref, got)
    if port_backend == "auto":
        diag_j, diag_t = ref[1]["binning"], got[1]["binning"]
        assert diag_t == {k: int(v) for k, v in diag_j.items()}


@pytest.mark.parametrize("jax_backend,port_backend",
                         [("tiled", "auto"), ("dense", "dense")])
def test_render_antialiased_matches_jax(jax_backend, port_backend):
    _assert_frames_close(*_render_both(jax_backend, port_backend, antialiased=True))


def test_render_active_degree_and_tile_x_match_jax():
    _assert_frames_close(*_render_both("tiled", "auto", cam_index=2, active=1))
    _assert_frames_close(*_render_both("tiled", "auto", tile_x=64,
                                       dup_capacity=4096, max_per_tile=1024))


def test_xys_probe_and_backend_names():
    state, leaves = _scene(n=50)
    ts = tt.from_jax_params(leaves, "cpu")
    cam = orbit_cameras(3, width=W, height=H)[0].params(device="cpu")
    bg = torch.zeros(3)
    probe = torch.full((ts.params.capacity, 2), 0.25)
    _, ex0 = tt.render(ts.params, ts.alive, cam, H, W, 3, bg)
    _, ex1 = tt.render(ts.params, ts.alive, cam, H, W, 3, bg, xys_probe=probe)
    np.testing.assert_allclose((ex1["xys"] - ex0["xys"]).numpy(), 0.25, atol=1e-4)
    for name in ("tiled", "pallas"):
        with pytest.raises(ValueError, match="dense"):
            tt.render(ts.params, ts.alive, cam, H, W, 3, bg, rasterizer=name)
    with pytest.raises(NotImplementedError):  # the dense oracle has no bands
        tt.render(ts.params, ts.alive, cam, H, W, 3, bg, rasterizer="dense", row_stride=2)
    # 8-px tiles (square: tile_x 0) render the JAX 'tiled' frame at the same
    # tile size. Not the dense oracle's: render's splats keep their 3-sigma
    # radii, and the tiles a radius box touches decide which pixels past it
    # (alpha still >= 1/255 out to 3.33 sigma) a splat reaches, at 16 px too.
    _assert_frames_close(*_render_both("tiled", "auto", cam_index=0, tile_size=8))


def test_init_from_pcd_matches_jax():
    pcd = synthetic_pcd(200, seed=2)
    ref = jg.init_from_pcd(pcd.xyz, pcd.colors, sh_degree=2, seed=0)
    n = pcd.xyz.shape[0]
    got = tt.init_from_pcd(pcd.xyz, pcd.colors, sh_degree=2,
                           quats=np.asarray(ref.params.quats)[:n], device="cpu")
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got.params, name).numpy(),
                                   np.asarray(getattr(ref.params, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
    assert int(got.active_sh_degree) == int(ref.active_sh_degree)
    drawn = tt.init_from_pcd(pcd.xyz, pcd.colors, seed=4, device="cpu")
    np.testing.assert_allclose(torch.linalg.norm(drawn.params.quats, dim=1).numpy(),
                               1.0, atol=1e-6)


def test_state_dict_round_trip_matches_jax():
    state, leaves = _scene(n=40, capacity=64)
    ts = tt.from_jax_params(leaves, "cpu")
    sd_t, sd_j = tt.state_dict(ts), jg.state_dict(state)
    assert sd_t.keys() == sd_j.keys()
    for k in sd_j:
        np.testing.assert_array_equal(sd_t[k], np.asarray(sd_j[k]), err_msg=k)
    back, ref = tt.from_state_dict(sd_t, device="cpu"), jg.from_state_dict(sd_j)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(back.params, name).numpy(),
                                      np.asarray(getattr(ref.params, name)), err_msg=name)
    np.testing.assert_array_equal(back.alive.numpy(), np.asarray(ref.alive))


def test_load_model_reads_jax_checkpoint(tmp_path):
    state, _ = _scene()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state, step=7)
    ref = jax_load_model(path)
    got = tt.load_model(path, device="cpu")
    assert got.capacity == ref.capacity
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got.params, name).numpy(),
                                      np.asarray(getattr(ref.params, name)), err_msg=name)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
    assert int(got.active_sh_degree) == int(ref.active_sh_degree) == 3
    bg = np.zeros(3, np.float32)
    jcam = jax_orbit_cameras(2, width=W, height=H)[0]
    rgb_j, _ = jax_render(ref.params, ref.alive, jcam.params(), H, W,
                          ref.active_sh_degree, jnp.asarray(bg), rasterizer="tiled")
    cam = orbit_cameras(2, width=W, height=H)[0].params(device="cpu")
    rgb_t, _ = tt.render(got.params, got.alive, cam, H, W, got.active_sh_degree,
                         torch.from_numpy(bg))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=2e-4)


def test_render_path_cli_writes_frames(tmp_path):
    state, _ = _scene(n=120)
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(ckpt, state)
    out = tmp_path / "frames"
    proc = subprocess.run(
        [sys.executable, "-m", "tinysplat_torch.render_path", ckpt, str(out),
         "--frames", "2", "--width", "48", "--height", "32", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png"]
    from PIL import Image

    img = np.asarray(Image.open(out / "frame_0000.png"))
    assert img.shape == (32, 48, 3) and img.max() > 0


def test_config_fields_and_defaults_match_jax():
    import dataclasses

    from tinysplat_tpu.config import Config as JaxConfig

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    # The JAX package's fields and defaults, and the port's own option at the
    # default that keeps the JAX package's behaviour.
    assert fields(tt.Config) == dict(fields(JaxConfig), mcmc_refine_every=0)
    assert tt.Config().rasterizer == "auto"
