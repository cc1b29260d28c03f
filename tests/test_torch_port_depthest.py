"""The port's depth estimation (``tinysplat_torch.depthest``) and the
``--regularize-depth`` step vs the JAX package's, on the real-photo COLMAP
fixture (tests/fixtures/real_colmap, loaded at ``max_image_dimension=160``).

- ``sparse_interp`` (the offline backend: SfM depths interpolated, then the
  Nelder-Mead scale fit) gives each camera the same map as the JAX
  package's, bit for bit, and writes the same ``.npy`` cache files;
- a second ``DepthEstimator`` reads the cache and never calls its backend,
  and one with a map missing calls it for that camera only;
- ``python -m tinysplat_torch.train_cli ... --regularize-depth`` trains on
  the fixture and fills the cache;
- two train steps with the depth loss from a state carried across
  (``from_jax_params``, dense rasterizer, background black): the loss and
  ``loss_depth`` to 1e-5 relative (as tests/test_torch_port_train.py holds
  the loss), the densify accumulator and Adam's first moment to 2e-4 x
  max, the second moment to 5e-4 x max. The fixture's SfM colours have
  channels of 0, whose SH colour sits exactly on the >= 0 clamp: the
  gradient there is split in half, as in the JAX package.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu import train as jt
from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.data.dataset import Dataset as JaxDataset
from tinysplat_tpu.depthest import DepthEstimator as JaxDepthEstimator
from tinysplat_tpu.models.gaussians import init_from_pcd as jax_init_from_pcd

import tinysplat_torch as tt
from tinysplat_torch import train_cli
from tinysplat_torch.config import Config
from tinysplat_torch.data import Dataset
from tinysplat_torch.depthest import DepthEstimator
from tinysplat_torch.depthest.backends import FunctionBackend
from tinysplat_torch.models.gaussians import PARAM_FIELDS
from tinysplat_torch.scene import Scene

from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "real_colmap")
SPARSE = os.path.join(FIXTURE, "sparse", "0")
IMAGES = os.path.join(FIXTURE, "images")
KW = dict(max_image_dimension=160, lazy_images=False)


def _scenes():
    ds, jds = Dataset(SPARSE, IMAGES, **KW), JaxDataset(SPARSE, IMAGES, **KW)
    return Scene(ds.cameras), ds.pcd, jds


def test_sparse_interp_maps_match_jax(tmp_path):
    scene, pcd, jds = _scenes()
    DepthEstimator(scene, pcd=pcd, depths_path=str(tmp_path / "port"),
                   model_name="sparse_interp")
    JaxDepthEstimator(jds, pcd=jds.pcd, depths_path=str(tmp_path / "jax"),
                      model_name="sparse_interp")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 8 and sorted(os.listdir(tmp_path / "port")) == names
    for cam, jcam in zip(scene.cameras, jds.cameras):
        assert cam.estimated_depth.shape == (cam.height, cam.width)
        assert cam.estimated_depth.dtype == np.float32
        assert np.isfinite(cam.estimated_depth).all() and cam.estimated_depth.min() > 0
        np.testing.assert_array_equal(cam.estimated_depth, jcam.estimated_depth)
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_a_second_estimator_reads_the_cache(tmp_path):
    scene, pcd, _ = _scenes()
    first = DepthEstimator(scene, pcd=pcd, depths_path=str(tmp_path),
                           model_name="sparse_interp")
    maps = [c.estimated_depth.copy() for c in scene.cameras]
    calls = []

    def counting(camera):
        calls.append(camera.name)
        return np.full((camera.height, camera.width), 2.0)

    backend = FunctionBackend(counting)
    fresh = Scene(Dataset(SPARSE, IMAGES, **KW).cameras)
    second = DepthEstimator(fresh, pcd=pcd, depths_path=str(tmp_path), model_name=backend)
    assert calls == [] and second.backend is None and first.backend is not None
    for cam, ref in zip(fresh.cameras, maps):
        np.testing.assert_array_equal(cam.estimated_depth, ref)
    # One map gone: only that camera goes to the backend.
    missing = fresh.cameras[3].name
    os.remove(tmp_path / f"{missing}.npy")
    DepthEstimator(fresh, pcd=pcd, depths_path=str(tmp_path), model_name=backend)
    assert calls == [missing]
    assert (tmp_path / f"{missing}.npy").exists()


def test_train_cli_regularize_depth_on_the_fixture(tmp_path):
    depths = tmp_path / "depths"
    tr = train_cli.main([
        "--train", "--dataset-dir", FIXTURE, "--colmap-path", "sparse/0",
        "--images-path", "images", "--device", "cpu", "--rasterizer", "dense",
        "--max-iter", "2", "--no-viewer", "--regularize-depth", "--depth-model",
        "sparse_interp", "--depths-path", str(depths), "--max-image-dimension", "96",
        "--no-prefetch-images"])
    assert tr.step == 2 and len(tr.scene.cameras) == 8
    assert len(os.listdir(depths)) == 8
    assert all(c.estimated_depth is not None for c in tr.scene.cameras)
    assert np.isfinite(float(tr.last_metrics["loss_depth"]))


def _leaves(jstate):
    d = {k: np.asarray(getattr(jstate.params, k)) for k in PARAM_FIELDS}
    d.update(alive=np.asarray(jstate.alive), active_sh_degree=int(jstate.active_sh_degree))
    return d


def test_depth_regularized_steps_match_jax(tmp_path):
    scene, pcd, jds = _scenes()
    DepthEstimator(scene, pcd=pcd, depths_path=str(tmp_path), model_name="sparse_interp")
    kw = dict(rasterizer="dense", sh_degree=1, background="black", warmup_grad=0,
              regularize_depth=True, regularize_depth_start=0, lambda_depth=0.5)
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    jstate = jax_init_from_pcd(jds.pcd.xyz, jds.pcd.colors, sh_degree=1, capacity=512)
    state = tt.from_jax_params(_leaves(jstate), "cpu")
    jopt, opt = jt.init_opt_state(jcfg, jstate), tt.init_opt_state(cfg, state)
    for step, cam in enumerate(scene.cameras[:2], start=1):
        h, w = cam.height, cam.width
        gt = cam.get_original_image()
        est = cam.estimated_depth
        jout = jt.make_train_step(jcfg, h, w)(
            jstate, jopt, jds.cameras[step - 1].params(), jnp.asarray(gt), jnp.asarray(est),
            jnp.int32(step), jax.random.PRNGKey(0))
        out = tt.make_train_step(cfg, h, w)(
            state, opt, cam.params("cpu"), torch.from_numpy(gt), torch.from_numpy(est), step)
        for key in ("loss", "loss_depth", "loss_l1"):
            np.testing.assert_allclose(float(out.metrics[key]), float(jout.metrics[key]),
                                       rtol=1e-5, err_msg=f"step {step} {key}")
        accum, jaccum = out.state.means_grad_accum.numpy(), np.asarray(
            jout.state.means_grad_accum)
        np.testing.assert_allclose(accum, jaccum, atol=2e-4 * np.abs(jaccum).max(), rtol=0)
        mu, nu, _ = out.opt_state.moments()
        # Not quats: from isotropic init scales their gradient is zero but
        # for rounding, so it has no scale to hold it to.
        for name in (f for f in PARAM_FIELDS if f != "quats"):
            for got, ref, rel in ((mu[name], jout.opt_state[0].mu, 2e-4),
                                  (nu[name], jout.opt_state[0].nu, 5e-4)):
                ref = np.asarray(getattr(ref, name))
                np.testing.assert_allclose(got.numpy(), ref, atol=rel * np.abs(ref).max(),
                                           rtol=0, err_msg=f"step {step} moment {name}")
        jstate, jopt, state, opt = jout.state, jout.opt_state, out.state, out.opt_state
    assert float(out.metrics["loss_depth"]) > 0
