"""Diffusion-guided novel views: the port (``tinysplat_torch.regularizers.
diffusion_guidance`` and ``Trainer(regularize_diffusion=True)``) against
the JAX package's.

Both packages load one pipeline: a tiny-topology native checkpoint (latent
4, images 32) written by the port's ``save_native`` and read by each
package's ``from_pretrained`` (the JAX side through its flax
``from_bytes``). JAX's ``load_native`` first builds ``tiny()`` with a
random init whose values it then overwrites; that init runs here on its
abstract shapes only (``jax.eval_shape``), which keeps the eager flax init
out of the test's time. The pipeline's draws (posterior eps, start noise)
come from ``jax.random.PRNGKey(seed)`` with the seed each refresh draws,
recomputed and handed to the port.

Tolerances: camera poses, names and count equal (float32 matrices to
1e-6); refined frames 1e-4 x max |JAX|; trainer losses per step within
rtol 1e-5 and parameters within 2e-4 x the field's max, the bars of
tests/test_torch_port_train.py and tests/test_torch_port_trainer.py; quats
5x that, as there: the splats start isotropic, where a rotation changes
nothing, so the quats' gradient is rounding residue whose relative error is
that much larger.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.diffusion import pipeline as jpipe
from tinysplat_tpu.regularizers import diffusion_guidance as jdg
from tinysplat_tpu.train_loop import Trainer as JaxTrainer

import tinysplat_torch as tt
from tinysplat_torch.config import Config
from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.diffusion.pipeline import TinysplatDiffusionPipeline
from tinysplat_torch.models.gaussians import PARAM_FIELDS
from tinysplat_torch.parallel import MeshTrainer
from tinysplat_torch.regularizers import diffusion_guidance as dg
from tinysplat_torch.train_loop import Trainer

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_port_trainer import jax_start, leaves_of, port_scene
from tests.test_train_loop import _toy_scene as jax_toy_scene

SIZE, CAMS = 32, 4
FRAME_TOL = 1e-4
GUIDED = dict(rasterizer="dense", sh_degree=1, background="black", warmup_grad=0,
              warmup_densify=10**9, interval_opacity_reset=0, prefetch_images=False,
              regularize_diffusion=True, lambda_diffusion=0.5, regularize_diffusion_start=2,
              regularize_diffusion_end=7, interval_diffusion=3, diffusion_inference_steps=4,
              diffusion_strength=0.5)


@pytest.fixture(scope="module")
def native_dir(tmp_path_factory):
    """A tiny-topology pipeline (latent 4 -> 32 x 32 frames) in the native
    format, written by the port."""
    d = str(tmp_path_factory.mktemp("native"))
    TinysplatDiffusionPipeline.tiny(sample_size=4, generator=torch.Generator().manual_seed(5),
                                    device="cpu").save_native(d)
    return d


@pytest.fixture(autouse=True)
def _abstract_jax_init(monkeypatch):
    """JAX's ``load_native`` builds ``tiny()`` and overwrites its params:
    shape that init abstractly (zeros), not eagerly."""
    orig = jpipe.TinysplatDiffusionPipeline.init_params

    def init_params(key, *modules):
        shapes = jax.eval_shape(lambda k: orig(k, *modules), key)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(jpipe.TinysplatDiffusionPipeline, "init_params",
                        staticmethod(init_params))


def _jax_draws(seed, latent_shape):
    """The JAX pipeline's posterior eps (drawn in NHWC) and start noise for
    ``PRNGKey(seed)``, as NCHW tensors."""
    k_enc, k_noise = jax.random.split(jax.random.PRNGKey(seed))
    b, c, h, w = latent_shape
    eps = np.asarray(jax.random.normal(k_enc, (b, h, w, c))).transpose(0, 3, 1, 2)
    noise = np.array(jax.random.normal(k_noise, latent_shape))
    return torch.from_numpy(np.ascontiguousarray(eps)), torch.from_numpy(noise)


@pytest.fixture
def jax_draws(monkeypatch):
    """Make the port's refinements take the JAX pipeline's draws."""
    def refine(self, init, cam_tg, cam_in, input_imgs, seed):
        lc = self.pipeline.vae.latent_channels
        eps, noise = _jax_draws(seed, (init.shape[0], lc, init.shape[2] // 8,
                                       init.shape[3] // 8))
        return self.pipeline(init, cam_tg, cam_in, input_imgs,
                             num_inference_steps=self.cfg.diffusion_inference_steps,
                             strength=self.cfg.diffusion_strength, eps=eps, noise=noise)

    monkeypatch.setattr(dg.DiffusionGuidance, "refine", refine)


@pytest.mark.parametrize("t,size", [(0.5, 32), (0.3, 24), (0.7, 128)])
def test_interpolate_camera_matches_jax(t, size):
    jcams = jax_orbit_cameras(8, width=64, height=48)
    cams = orbit_cameras(8, width=64, height=48)
    for a, b in ((0, 1), (3, 4), (7, 0)):
        ref = jdg.interpolate_camera(jcams[a], jcams[b], t, size=size, name="m")
        got = dg.interpolate_camera(cams[a], cams[b], t, size=size, name="m")
        assert (got.width, got.height, got.name) == (ref.width, ref.height, ref.name) == (
            size, size, "m")
        assert (got.f_x, got.f_y, got.fov_x, got.fov_y) == (ref.f_x, ref.f_y, ref.fov_x,
                                                             ref.fov_y)
        for attr in ("position", "view_matrix", "proj_matrix"):
            np.testing.assert_allclose(getattr(got, attr), np.asarray(getattr(ref, attr)),
                                       atol=1e-6, err_msg=attr)


def test_rotmat_to_quat_and_slerp_match_jax():
    """Both branches of Shepperd's method (trace > 0 and each largest
    diagonal entry) and both of slerp (near-parallel: lerp)."""
    from scipy.spatial.transform import Rotation

    rots = Rotation.from_rotvec(np.array([[0.1, 0.2, 0.3], [np.pi * 0.99, 0, 0],
                                          [0, np.pi * 0.98, 0.1], [0.1, 0, np.pi * 0.97]]))
    for r in rots.as_matrix():
        np.testing.assert_allclose(dg._rotmat_to_quat(r), jdg._rotmat_to_quat(r), atol=1e-12)
    qa, qb = np.array([1.0, 0, 0, 0]), np.array([0.6, 0.8, 0, 0])
    for b, t in ((qb, 0.3), (-qb, 0.6), (qa + 1e-4, 0.5)):
        np.testing.assert_allclose(dg._slerp(qa, b, t), jdg._slerp(qa, b, t), atol=1e-12)


def _trainers(native_dir, **kw):
    jscene = jax_toy_scene(n_cams=CAMS, size=SIZE)
    jcfg = JaxConfig(**dict(GUIDED, diffusion_model_dir=native_dir, **kw))
    cfg = Config(**dict(GUIDED, diffusion_model_dir=native_dir, **kw))
    jtr = JaxTrainer(jcfg, jscene, jax_start())
    tr = Trainer(cfg, port_scene(jscene), tt.from_jax_params(leaves_of(jax_start()), "cpu"))
    return jtr, tr


def _assert_same_cameras(got, ref):
    assert [c.name for c in got] == [c.name for c in ref]
    for g, r in zip(got, ref):
        assert (g.width, g.height) == (r.width, r.height)
        np.testing.assert_allclose(g.view_matrix, np.asarray(r.view_matrix), atol=1e-6)
        np.testing.assert_allclose(g.proj_matrix, np.asarray(r.proj_matrix), atol=1e-6)


def test_refresh_matches_jax(native_dir, jax_draws):
    """One refresh from the same state: equal novel cameras, frames within
    FRAME_TOL x max; a second refresh draws new poses from the same stream."""
    jtr, tr = _trainers(native_dir)
    jg = jdg.DiffusionGuidance(jtr.cfg, rng_seed=3)
    g = dg.DiffusionGuidance(tr.cfg, rng_seed=3, device="cpu")
    for _ in range(2):
        ref = jg.refresh(jtr, list(jtr.scene.cameras))
        got = g.refresh(tr, list(tr.scene.cameras))
        assert len(got) == 2  # lambda 0.5 x 4 real views
        _assert_same_cameras(got, ref)
        for gc, rc in zip(got, ref):
            want = np.asarray(rc.get_original_image())
            frame = gc.get_original_image()
            assert frame.shape == want.shape == (SIZE, SIZE, 3) and frame.dtype == np.float32
            np.testing.assert_allclose(frame, want, atol=FRAME_TOL * np.abs(want).max(),
                                       rtol=0)
    assert g.size == jg.size == SIZE and g.pipeline.feature_encoder is not None


def test_trainer_with_diffusion_views_matches_jax(native_dir, jax_draws):
    """8 steps: refreshes at steps 2 (the window start), 3 and 6 (every 3),
    the window's end at 7 puts the 4 real views back. Per step the scene's
    cameras equal JAX's, the loss is within rtol 1e-5; at the end the
    parameters are within 2e-4 x the field's max."""
    jtr, tr = _trainers(native_dir)
    jax_losses, losses, counts = [], [], []
    update = jtr.metrics.update

    def record(step, values):
        jax_losses.append(float(jax.device_get(values["loss"])))
        update(step, values)

    jtr.metrics.update = record
    for step in range(1, 9):
        jtr.run(step)
        tr.run(step)
        _assert_same_cameras(tr.scene.cameras, jtr.scene.cameras)
        counts.append(len(tr.scene.cameras))
        losses.append(float(tr.last_metrics["loss"]))
        live = {c.name for c in tr.scene.cameras}
        assert {k[0] for k in tr._image_cache} <= live  # no stale synthetic frames
    assert counts == [4, 6, 6, 6, 6, 6, 4, 4]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    for name in PARAM_FIELDS:
        got = getattr(tr.state.params, name).detach().numpy()
        want = np.asarray(getattr(jtr.state.params, name))
        k = 5.0 if name == "quats" else 1.0  # isotropic starts: see the module doc
        np.testing.assert_allclose(got, want, atol=k * 2e-4 * np.abs(want).max(), rtol=0,
                                   err_msg=name)
    assert np.isfinite(losses).all()


def test_mesh_trainer_refuses_diffusion(native_dir):
    """JAX's MeshTrainer skips the diffusion views silently; the port's
    refuses the flag and names the single-device trainer."""
    cfg = Config(**dict(GUIDED, diffusion_model_dir=native_dir))
    state = tt.from_jax_params(leaves_of(jax_start()), "cpu")
    with pytest.raises(ValueError, match="single-device trainer"):
        MeshTrainer(cfg, port_scene(jax_toy_scene(n_cams=CAMS, size=SIZE)), state)
    tr = MeshTrainer(dataclasses.replace(cfg, regularize_diffusion=False),
                     port_scene(jax_toy_scene(n_cams=CAMS, size=SIZE)), state)
    assert tr._diffusion_guidance is None
