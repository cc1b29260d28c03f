"""The port's diffusion modules (``tinysplat_torch.diffusion``,
``utils.rays``, ``utils.resize``) against the JAX package's, on the CPU.

Weights cross in both directions through ``diffusion/convert.py``: the tiny
topology's port modules are drawn at random (``pipeline.init_weights``) and
carried to flax trees whose structure (paths and shapes) must equal the
JAX module's own ``init`` (traced abstractly, ``jax.eval_shape``); the JAX
pipeline is JAX's own ``tiny()`` with those weights in place of its init.
The SD topology runs at the tiny configs of tests/test_diffusion_port.py,
and its diffusers directories are written here (safetensors F32 / F16 and
``.bin``) and read by both packages. JAX's draws (the posterior eps, drawn
in NHWC, and the start noise) are recomputed from the key and handed over.

Tolerances: single modules 1e-5 x max |JAX output|; the whole pipeline
1e-4 x max; the resize helper 2e-5 x max (JAX's cubic weights round
differently, ~3e-6 relative); loaded weights and msgpack trees exactly.
"""
import functools
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.diffusion.clip import encode_cross_attention_inputs as jax_encode
from tinysplat_tpu.diffusion import model_diffusion as jmd
from tinysplat_tpu.diffusion import pipeline as jpipe
from tinysplat_tpu.diffusion import port as jport
from tinysplat_tpu.diffusion import scheduler as jsched
from tinysplat_tpu.diffusion.sd_unet import UNet2DConditionModel as JaxSDUNet
from tinysplat_tpu.diffusion.sd_vae import SDAutoencoderKL as JaxSDVAE
from tinysplat_tpu.diffusion.unet import UNet2D as JaxUNet2D
from tinysplat_tpu.diffusion.vae import AutoencoderKL as JaxVAE
from tinysplat_tpu.utils.rays import unproj_map as jax_unproj_map

from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.diffusion import convert, flax_msgpack, model_diffusion, port, scheduler
from tinysplat_torch.diffusion.clip import encode_cross_attention_inputs
from tinysplat_torch.diffusion.pipeline import (
    TinysplatDiffusionPipeline, _dummy_cams, init_weights, prepare_feature_latents,
    stack_cameras)
from tinysplat_torch.diffusion.sd_unet import UNet2DConditionModel
from tinysplat_torch.diffusion.sd_vae import SDAutoencoderKL
from tinysplat_torch.utils.device import full_f32
from tinysplat_torch.utils.rays import unproj_map
from tinysplat_torch.utils.resize import resize

from tests.test_diffusion_port import UNET_CFG, VAE_CFG, unet_torch_keys, vae_torch_keys
from tests._torch_threads import one_torch_thread  # noqa: F401

MODULE_TOL, PIPE_TOL, RESIZE_TOL = 1e-5, 1e-4, 2e-5
S = 4  # tiny latent size: images 32 x 32, feature-encoder input 8 x 8


def close(got, ref, tol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=tol * max(float(np.abs(ref).max()), 1e-12),
                               rtol=0, err_msg=what)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _jax_draws(key, latent_shape):
    k_enc, k_noise = jax.random.split(key)
    b, c, h, w = latent_shape
    eps = np.asarray(jax.random.normal(k_enc, (b, h, w, c))).transpose(0, 3, 1, 2)
    return t(eps), t(jax.random.normal(k_noise, latent_shape))


def _flax_like(shapes, sd):
    """A flax tree shaped as ``shapes`` (an eval_shape'd init) whose leaves
    are the SD port module's state dict ``sd``, by the JAX package's own
    flax path -> diffusers key rule."""
    def leaf(path, s):
        fp = tuple(str(getattr(p, "key", p)) for p in path)
        w = sd[jport._torch_key(fp)].numpy()
        w = convert._to_flax_layout(fp[-1], w)
        assert w.shape == tuple(s.shape), fp
        return jnp.asarray(w)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# -- resize, rays --------------------------------------------------------------------


@pytest.mark.parametrize("shape,size,method", [
    ((64, 48), (32, 24), "linear"),  # model_diffusion: S -> D
    ((64, 48), (20, 17), "linear"),  # a non-integer factor
    ((2, 3, 64, 48), (224, 224), "cubic"),  # clip_preprocess
    ((2, 3, 8, 8), (16, 16), "nearest"),  # the UNets' / VAE's 2x upsample
    ((1, 2, 3, 5, 16, 16), (8, 8), "linear"),  # xyz_vol: the last two axes only
    ((16, 16), (40, 40), "linear"),  # upsampling
])
def test_resize_matches_jax_image_resize(shape, size, method):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), shape[:-2] + size, method)
    close(resize(t(x), size, method), ref, RESIZE_TOL, method)


def test_resize_of_a_camera_image_as_the_guidance_does():
    """diffusion_guidance: an (H, W, 3) frame, not square, to (s_fe, s_fe)."""
    img = np.random.default_rng(1).uniform(size=(30, 40, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (8, 8, 3), "linear")).transpose(2, 0, 1)
    close(resize(t(img).permute(2, 0, 1), (8, 8), "linear"), ref, RESIZE_TOL)


@pytest.mark.parametrize("w,h,fx,fy,cx,cy", [(8, 8, 4.0, 4.0, None, None),
                                             (16, 12, 10.5, 9.25, 7.0, 5.5)])
def test_unproj_map_matches_jax(w, h, fx, fy, cx, cy):
    ref = jax_unproj_map(w, h, jnp.float32(fx), jnp.float32(fy), cx, cy)
    close(unproj_map(w, h, torch.tensor(fx), torch.tensor(fy), cx, cy), ref, MODULE_TOL)


def test_full_f32_restores_the_tf32_flags():
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with full_f32():
            assert [f.allow_tf32 for f in flags] == [False, False]
        assert [f.allow_tf32 for f in flags] == [True, True]
        with pytest.raises(RuntimeError):
            with full_f32():
                raise RuntimeError("restored on the way out of an error too")
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


# -- the scheduler ---------------------------------------------------------------------


@pytest.mark.parametrize("prediction_type,schedule", [("epsilon", "scaled_linear"),
                                                      ("v_prediction", "linear")])
def test_scheduler_matches_jax(prediction_type, schedule):
    kw = dict(num_train_timesteps=100, beta_schedule=schedule, prediction_type=prediction_type)
    js, ps = jsched.DDIMScheduler(**kw), scheduler.DDIMScheduler(**kw)
    np.testing.assert_array_equal(ps.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    np.testing.assert_array_equal(ps.timesteps(7).numpy(), np.asarray(js.timesteps(7)))
    rng = np.random.default_rng(2)
    x, n, e = (rng.normal(size=(1, 4, 4, 4)).astype(np.float32) for _ in range(3))
    close(ps.add_noise(t(x), t(n), 42), js.add_noise(x, n, 42), MODULE_TOL)
    for tt_, prev in ((85, 71), (15, 1), (1, -1)):
        close(ps.step(t(e), tt_, t(x), prev), js.step(e, tt_, x, jnp.int32(prev)), MODULE_TOL,
              f"{tt_} -> {prev}")


def test_scheduler_from_config_file_warns_as_jax(tmp_path, caplog):
    path = tmp_path / "scheduler_config.json"
    path.write_text(json.dumps({
        "num_train_timesteps": 50, "beta_schedule": "linear", "beta_start": 0.001,
        "beta_end": 0.01, "clip_sample": True, "steps_offset": 1, "timestep_spacing": "leading",
        "set_alpha_to_one": False, "rescale_betas_zero_snr": True, "thresholding": True,
        "prediction_type": "v_prediction"}))
    with caplog.at_level(logging.WARNING):
        ps = scheduler.DDIMScheduler.from_config_file(str(path))
    port_msgs = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        js = jsched.DDIMScheduler.from_config_file(str(path))
    assert port_msgs == [r.getMessage() for r in caplog.records] and len(port_msgs) == 6
    assert (ps.num_train_timesteps, ps.prediction_type) == (50, "v_prediction")
    np.testing.assert_array_equal(ps.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    path.write_text(json.dumps({"prediction_type": "sample"}))
    with pytest.raises(NotImplementedError, match="sample"):
        scheduler.DDIMScheduler.from_config_file(str(path))


# -- the tiny topology -----------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    """(port tiny pipeline at latent S, its flax params, JAX's tiny()
    pipeline holding those params)."""
    pipe = TinysplatDiffusionPipeline.tiny(sample_size=S,
                                           generator=torch.Generator().manual_seed(3),
                                           device="cpu")
    params = {k: convert.tiny_flax_variables(m) for k, m in pipe.parts().items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe.TinysplatDiffusionPipeline, "init_params",
                   staticmethod(lambda *a: jax.tree.map(jnp.asarray, params)))
        jp = jpipe.TinysplatDiffusionPipeline.tiny(jax.random.PRNGKey(0), sample_size=S)
    return pipe, params, jp


def test_tiny_flax_trees_match_jax_init_structure(pipes):
    """Every port module's flax tree has the paths and shapes of the JAX
    module's own init; the conversion round-trips."""
    pipe, params, jp = pipes
    shapes = jax.eval_shape(lambda k: jpipe.TinysplatDiffusionPipeline.init_params(
        k, jp.feature_encoder, jp.feature_aggregator, jp.embedding_mlp, jp.unet, jp.vae, S, 4),
        jax.random.PRNGKey(0))
    for part, mod in pipe.parts().items():
        want = {p: s.shape for p, s in jax.tree_util.tree_flatten_with_path(shapes[part])[0]}
        got = {p: v.shape for p, v in jax.tree_util.tree_flatten_with_path(params[part])[0]}
        assert got == want, part
        sd = convert.tiny_state_dict(mod, params[part])
        assert sd.keys() == mod.state_dict().keys()
        for k, v in mod.state_dict().items():
            assert torch.equal(sd[k], v), k


def test_tiny_unets_and_vae_match_jax(pipes):
    pipe, params, jp = pipes
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, 4 + 8 + 3, S, S)).astype(np.float32)
    ctx = rng.normal(size=(2, 2, 32)).astype(np.float32)
    with torch.no_grad():
        ref = jax.jit(jp.unet.apply)(params["unet"], lat, jnp.asarray([37.0]), ctx)
        close(pipe.unet(t(lat), torch.tensor([37.0]), t(ctx)), ref, MODULE_TOL, "UNet2DCondition")
        enc = JaxUNet2D(sample_size=2 * S, in_channels=3, out_channels=8,
                        block_out_channels=(8, 16))  # the feature encoder's
        img = rng.uniform(size=(2, 3, 2 * S, 2 * S)).astype(np.float32)
        ref = jax.jit(enc.apply)({"params": params["fe"]["params"]["encoder"]}, img,
                                 jnp.ones((1,)))
        close(pipe.feature_encoder.encoder(t(img), torch.ones(1)), ref, MODULE_TOL, "UNet2D")
        img = rng.uniform(-1, 1, size=(1, 3, 8 * S, 8 * S)).astype(np.float32)
        key = jax.random.PRNGKey(5)
        z = jp.vae.apply(params["vae"], img, key, method=JaxVAE.encode)
        eps = t(np.asarray(jax.random.normal(key, (1, S, S, 4))).transpose(0, 3, 1, 2))
        close(pipe.vae.encode(t(img), eps=eps), z, MODULE_TOL, "encode")
        ref = jp.vae.apply(params["vae"], z, method=JaxVAE.decode)
        close(pipe.vae.decode(t(z)), ref, MODULE_TOL, "decode")


def _cams(n_views=3, batched_inputs=2):
    """JAX and port (target, inputs) camera batches from orbit cameras."""
    jc, pc = jax_orbit_cameras(n_views, width=40, height=30), orbit_cameras(n_views, width=40,
                                                                           height=30)
    j_tg = jax.tree.map(lambda x: x[None], jc[0].params())
    j_in = jax.tree.map(lambda *xs: jnp.stack(xs)[None],
                        *[c.params() for c in jc[1:1 + batched_inputs]])
    p_tg = stack_cameras(pc[:1], "cpu")
    p_in = stack_cameras([pc[1:1 + batched_inputs]], "cpu")
    return (j_tg, j_in), (p_tg, p_in)


def test_feature_conditioning_matches_jax(pipes):
    """The feature encoder, aggregator, EmbeddingMLP, prepare_feature_latents
    (with its CFG zero half) and clip_preprocess."""
    pipe, params, jp = pipes
    (j_tg, j_in), (p_tg, p_in) = _cams()
    rng = np.random.default_rng(6)
    imgs = rng.uniform(size=(1, 2, 3, 2 * S, 2 * S)).astype(np.float32)
    with torch.no_grad():
        fj, xj = jp.feature_encoder.apply(params["fe"], j_tg, imgs, j_in)
        fp, xp = pipe.feature_encoder(p_tg, t(imgs), p_in)
        close(fp, fj, MODULE_TOL, "features")
        close(xp, xj, MODULE_TOL, "xyz")
        close(pipe.feature_aggregator(fp, xp),
              jp.feature_aggregator.apply(params["fa"], fj, xj), MODULE_TOL, "aggregator")
        ref = jpipe.prepare_feature_latents(jp.feature_encoder, jp.feature_aggregator, params,
                                            j_tg, j_in, imgs, True)
        got = prepare_feature_latents(pipe.feature_encoder, pipe.feature_aggregator, p_tg,
                                      p_in, t(imgs), True)
        close(got, ref, MODULE_TOL, "feature latents")
        assert not got[0].any()
        text, image = (rng.normal(size=(1, 2, 32)).astype(np.float32) for _ in range(2))
        close(pipe.embedding_mlp(t(text), t(image)),
              jp.embedding_mlp.apply(params["em"], text, image), MODULE_TOL, "EmbeddingMLP")
        x = rng.uniform(-1, 1, size=(2, 3, 20, 28)).astype(np.float32)
        close(model_diffusion.clip_preprocess(t(x)), jmd.clip_preprocess(x), RESIZE_TOL, "clip")
        # The identity cameras both packages use to build their modules.
        jd, pd = jpipe._dummy_cams(2), _dummy_cams(2)
        for f in ("viewmat", "projmat", "cam_pos", "fx", "fy", "cx_off", "cy_off"):
            np.testing.assert_array_equal(getattr(pd, f).numpy(), np.asarray(getattr(jd, f)))


def test_trilinear_and_ndc_projection_match_jax():
    rng = np.random.default_rng(7)
    vol = rng.normal(size=(5, 6, 7)).astype(np.float32)
    coords = rng.uniform(-2, 8, size=(300, 3)).astype(np.float32)
    close(model_diffusion._trilinear_border(t(vol), t(coords)),
          jmd._trilinear_border(vol, coords), MODULE_TOL)
    coords[:3] = np.nan  # a NaN coordinate samples NaN, as in JAX
    assert torch.isnan(model_diffusion._trilinear_border(t(vol), t(coords))[:3]).all()
    cam = orbit_cameras(2, width=32, height=24)[1]
    jcam = jax_orbit_cameras(2, width=32, height=24)[1]
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    close(model_diffusion.project_points_ndc(cam.params("cpu"), t(pts)),
          jmd.project_points_ndc(jcam.params(), pts), MODULE_TOL)


@pytest.mark.parametrize("strength", [0.0, 0.5, 1.0])
def test_tiny_pipeline_matches_jax(pipes, strength):
    """The whole pipeline (CFG at guidance 3): strength 0 decodes the init,
    0.5 runs the last 2 of 4 DDIM steps, 1 all 4."""
    pipe, params, jp = pipes
    (j_tg, j_in), (p_tg, p_in) = _cams()
    rng = np.random.default_rng(8)
    init = rng.uniform(-1, 1, size=(1, 3, 8 * S, 8 * S)).astype(np.float32)
    imgs = rng.uniform(size=(1, 2, 3, 2 * S, 2 * S)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jp(jnp.asarray(init), j_tg, j_in, jnp.asarray(imgs), num_inference_steps=4,
             strength=strength, key=key)
    eps, noise = _jax_draws(key, (1, 4, S, S))
    got = pipe(t(init), p_tg, p_in, t(imgs), num_inference_steps=4, strength=strength,
               eps=eps, noise=noise)
    close(got, ref, PIPE_TOL, f"strength {strength}")


def test_encode_cross_attention_inputs_matches_jax(pipes):
    """With a stand-in for the CLIP models (no weights here): the tokens
    and their CFG negative half."""
    pipe, params, jp = pipes
    rng = np.random.default_rng(10)
    text = rng.normal(size=(1, 5, 32)).astype(np.float32)
    image = rng.normal(size=(4, 32)).astype(np.float32)

    class Clip:
        def encode_text(self, prompts):
            return text

        def encode_images(self, images):
            assert images.min() >= -1.0 and images.shape[0] == 4
            return image

    imgs = rng.uniform(size=(2, 2, 3, 8, 8)).astype(np.float32)
    for cfg in (False, True):
        close(encode_cross_attention_inputs(Clip(), pipe.embedding_mlp, imgs, cfg),
              jax_encode(Clip(), jp.embedding_mlp, params["em"], imgs, cfg), MODULE_TOL)


# -- the native format -------------------------------------------------------------------


def test_msgpack_codec_writes_flax_bytes():
    """Every header width the subset has: maps of 20 keys (map16), long
    keys (str8), payloads of each ext width, zero-dim and empty arrays, and
    the dtypes a checkpoint may hold."""
    import flax.serialization

    rng = np.random.default_rng(30)
    tree = {f"layer_{i:02d}_with_a_name_longer_than_31_chars": {
        "kernel": rng.normal(size=(i + 1, 3)).astype(np.float32)} for i in range(20)}
    tree["big"] = {"w": rng.normal(size=(300, 300)).astype(np.float32),  # ext32
                   "h": rng.normal(size=(40, 40)).astype(np.float16),  # ext16
                   "s": np.asarray(3.5, np.float32), "e": np.zeros((0, 4), np.int32),
                   "b": rng.uniform(size=7) > 0.5, "i": np.arange(5, dtype=np.int64)}
    ref = flax.serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == ref
    back = flax_msgpack.from_bytes(ref)
    flat_ref = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in flat_ref:
        assert flat[path].dtype == leaf.dtype and np.array_equal(flat[path], leaf), path
    with pytest.raises(ValueError, match="not in the subset"):
        flax_msgpack.from_bytes(b"\xc3")


def test_native_format_loads_in_both_packages(pipes, tmp_path, monkeypatch):
    """The port writes flax's to_bytes bytes exactly; each package loads the
    other's checkpoint with every tensor equal."""
    import flax.serialization

    pipe, params, jp = pipes
    assert flax_msgpack.to_bytes(params) == flax.serialization.to_bytes(params)
    assert jax.tree.all(jax.tree.map(np.array_equal, flax_msgpack.from_bytes(
        flax.serialization.to_bytes(params)), params))
    pipe.save_native(str(tmp_path / "port"))
    orig = jpipe.TinysplatDiffusionPipeline.init_params
    monkeypatch.setattr(jpipe.TinysplatDiffusionPipeline, "init_params", staticmethod(
        lambda k, *m: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   jax.eval_shape(lambda kk: orig(kk, *m), k))))
    loaded = jpipe.TinysplatDiffusionPipeline.from_pretrained(str(tmp_path / "port"))
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b),
                                     loaded.params, params))
    jp.save_native(str(tmp_path / "jax"))
    back = TinysplatDiffusionPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    for part, mod in back.parts().items():
        for k, v in mod.state_dict().items():
            assert torch.equal(v, pipe.parts()[part].state_dict()[k]), (part, k)
    assert back.unet.sample_size == S and back.vae.latent_channels == 4


# -- the SD topology ---------------------------------------------------------------------


def _sd_unet(cfg, seed):
    return init_weights(UNet2DConditionModel(cfg), torch.Generator().manual_seed(seed)).eval()


def _sd_vae(cfg, seed):
    return init_weights(SDAutoencoderKL(cfg), torch.Generator().manual_seed(seed)).eval()


def _with_random_norms(mod, seed):
    """Norm scales and biases drawn too: a unit scale would hide a
    weight / bias swap."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm, torch.nn.Conv2d,
                              torch.nn.Linear)) and m.bias is not None:
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
    return mod


def test_sd_state_dict_keys_are_the_diffusers_keys():
    """The golden keys tests/test_diffusion_port.py enumerates
    independently of both packages."""
    assert set(UNet2DConditionModel(UNET_CFG).state_dict()) == set(unet_torch_keys())
    assert set(SDAutoencoderKL(VAE_CFG).state_dict()) == set(vae_torch_keys())


@pytest.mark.parametrize("linear", [False, True])
def test_sd_unet_matches_jax(linear):
    cfg = dict(UNET_CFG, use_linear_projection=linear, attention_head_dim=[2, 4],
               flip_sin_to_cos=not linear, freq_shift=1 if linear else 0)
    model = _with_random_norms(_sd_unet(cfg, 11), 12)
    jm = JaxSDUNet(cfg)
    x = np.random.default_rng(13).normal(size=(2, 4, 8, 8)).astype(np.float32)
    ctx = np.random.default_rng(14).normal(size=(2, 3, 8)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, 8)))
    params = _flax_like(shapes, model.state_dict())
    ref = jax.jit(jm.apply)(params, x.transpose(0, 2, 3, 1), jnp.asarray([3, 500]), ctx)
    with torch.no_grad():
        got = model(t(x), torch.tensor([3, 500]), t(ctx))
    close(got, np.asarray(ref).transpose(0, 3, 1, 2), MODULE_TOL)
    back = convert.sd_state_dict(jax.device_get(params))
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_sd_vae_matches_jax():
    model = _with_random_norms(_sd_vae(VAE_CFG, 15), 16)
    jm = JaxSDVAE(VAE_CFG)
    x = np.random.default_rng(17).uniform(-1, 1, size=(1, 3, 16, 16)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                            jax.random.PRNGKey(1))
    params = _flax_like(shapes, model.state_dict())
    mean, logvar = jm.apply(params, x.transpose(0, 2, 3, 1), method=JaxSDVAE.encode)
    with torch.no_grad():
        pm, plv = model.encode(t(x), sample=False)
        close(pm, np.asarray(mean).transpose(0, 3, 1, 2), MODULE_TOL, "mean")
        close(plv, np.asarray(logvar).transpose(0, 3, 1, 2), MODULE_TOL, "logvar")
        z = np.random.default_rng(18).normal(size=(1, 4, 8, 8)).astype(np.float32)
        ref = jm.apply(params, z.transpose(0, 2, 3, 1), method=JaxSDVAE.decode)
        close(model.decode(t(z)), np.asarray(ref).transpose(0, 3, 1, 2), MODULE_TOL, "decode")


def _write_dir(root, sub, cfg, sd, fmt):
    d = os.path.join(root, sub)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    if fmt == "bin":
        torch.save(dict(sd), os.path.join(d, "diffusion_pytorch_model.bin"))
    else:
        port.write_safetensors(os.path.join(d, "diffusion_pytorch_model.safetensors"), sd, fmt)
    return d


@pytest.mark.parametrize("fmt", ["F32", "F16", "bin"])
def test_diffusers_directory_loads_in_both_packages(tmp_path, fmt):
    """A diffusers directory written here: each package's load_unet /
    load_vae gives the same weights (F16 upcast to float32) and outputs."""
    unet, vae = _sd_unet(UNET_CFG, 19), _sd_vae(VAE_CFG, 20)
    ud = _write_dir(str(tmp_path), "unet", UNET_CFG, unet.state_dict(), fmt)
    vd = _write_dir(str(tmp_path), "vae", VAE_CFG, vae.state_dict(), fmt)
    pu, pv = port.load_unet(ud, device="cpu"), port.load_vae(vd, device="cpu")
    ju, jpu = jport.load_unet(ud)
    jv, jpv = jport.load_vae(vd)
    for mod, jparams in ((pu, jpu), (pv, jpv)):
        ref = convert.sd_state_dict(jax.device_get(jparams))
        assert all(torch.equal(ref[k], v) for k, v in mod.state_dict().items())
    if fmt == "F32":
        assert all(torch.equal(v, unet.state_dict()[k]) for k, v in pu.state_dict().items())
    x = np.random.default_rng(21).normal(size=(1, 4, 8, 8)).astype(np.float32)
    ctx = np.zeros((1, 3, 8), np.float32)
    with torch.no_grad():
        got = pu(t(x), torch.tensor([7]), t(ctx))
    ref = jax.jit(ju.apply)(jpu, x.transpose(0, 2, 3, 1), jnp.asarray([7]), ctx)
    close(got, np.asarray(ref).transpose(0, 3, 1, 2), MODULE_TOL)


def test_vae_legacy_attention_names_load(tmp_path):
    vae = _sd_vae(VAE_CFG, 22)
    legacy = {k.replace("to_q", "query").replace("to_k", "key").replace("to_v", "value")
               .replace("to_out.0", "proj_attn"): v for k, v in vae.state_dict().items()}
    assert legacy.keys() != vae.state_dict().keys()
    vd = _write_dir(str(tmp_path), "vae", VAE_CFG, legacy, "F32")
    loaded = port.load_vae(vd, device="cpu")
    assert all(torch.equal(v, vae.state_dict()[k]) for k, v in loaded.state_dict().items())


def test_unused_and_missing_tensors_are_reported_as_jax(tmp_path, caplog):
    sd = dict(_sd_unet(UNET_CFG, 23).state_dict())
    sd["extra.weight"] = torch.zeros(3)
    ud = _write_dir(str(tmp_path), "unet", UNET_CFG, sd, "F32")
    with caplog.at_level(logging.WARNING):
        port.load_unet(ud, device="cpu")
    assert "1 checkpoint tensors had no place" in caplog.text and "extra.weight" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jport.load_unet(ud)
    assert "1 checkpoint tensors had no place" in caplog.text
    del sd["extra.weight"], sd["conv_in.bias"]
    ud = _write_dir(str(tmp_path / "m"), "unet", UNET_CFG, sd, "F32")
    for load in (functools.partial(port.load_unet, device="cpu"), jport.load_unet):
        with pytest.raises(KeyError, match="missing torch weights for: \\['conv_in.bias'\\]"):
            load(ud)


@pytest.mark.parametrize("eos,act", [(98, "quick_gelu"), (2, "gelu")])
def test_clip_text_encoder_matches_transformers_and_jax(tmp_path, eos, act):
    """transformers' CLIPTextModel is the reference the JAX port was built
    against; eos_token_id 2 keeps the legacy argmax pooling."""
    from transformers import CLIPTextConfig
    from transformers import CLIPTextModel as TorchCLIP

    tcfg = CLIPTextConfig(vocab_size=99, hidden_size=32, intermediate_size=37,
                          num_hidden_layers=2, num_attention_heads=4,
                          max_position_embeddings=16, eos_token_id=eos, bos_token_id=97,
                          hidden_act=act)
    torch.manual_seed(0)
    tm = TorchCLIP(tcfg).eval()
    d = tmp_path / "text_encoder"
    d.mkdir()
    (d / "config.json").write_text(tcfg.to_json_string())
    torch.save(tm.state_dict(), d / "pytorch_model.bin")
    model = port.load_text_encoder(str(d), device="cpu")
    ids = np.array([[3, 17, 58, 97, 7, 98], [97, 5, 2, 98, 11, 1]], np.int64)
    with torch.no_grad():
        ref = tm(input_ids=torch.from_numpy(ids))
        hidden, pooled = model(torch.from_numpy(ids))
    close(hidden, ref.last_hidden_state.numpy(), MODULE_TOL, "hidden")
    close(pooled, ref.pooler_output.numpy(), MODULE_TOL, "pooled")
    jm, jparams = jport.load_text_encoder(str(d))
    jh, jpool = jax.jit(jm.apply)(jparams, jnp.asarray(ids.astype(np.int32)))
    close(hidden, jh, MODULE_TOL, "hidden vs JAX")
    close(pooled, jpool, MODULE_TOL, "pooled vs JAX")
    # The same weights from model.safetensors, without the text_model. prefix.
    st = tmp_path / "st"
    st.mkdir()
    (st / "config.json").write_text(tcfg.to_json_string())
    port.write_safetensors(str(st / "model.safetensors"),
                           {k[len("text_model."):]: v for k, v in tm.state_dict().items()
                            if k != "text_model.embeddings.position_ids"})
    again = port.load_text_encoder(str(st), device="cpu")
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in again.state_dict().items())


def _write_pipeline_dir(root, unet_cfg, seed):
    _write_dir(root, "unet", unet_cfg, _sd_unet(unet_cfg, seed).state_dict(), "F16")
    _write_dir(root, "vae", VAE_CFG, _sd_vae(VAE_CFG, seed + 1).state_dict(), "F16")
    os.makedirs(os.path.join(root, "scheduler"))
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"num_train_timesteps": 50, "beta_schedule": "linear", "beta_start": 0.001,
                   "beta_end": 0.01}, f)


def test_sd_pipeline_from_pretrained_matches_jax(tmp_path):
    """A stock 4-channel SD layout: no feature conditioning; the pipeline
    with CFG at strength 0.5 against JAX's, with JAX's random
    EmbeddingMLP weights carried over."""
    _write_pipeline_dir(str(tmp_path), UNET_CFG, 24)
    pipe = TinysplatDiffusionPipeline.from_pretrained(str(tmp_path), device="cpu")
    jp = jpipe.TinysplatDiffusionPipeline.from_pretrained(str(tmp_path))
    assert pipe.feature_encoder is None and jp.feature_encoder is None
    assert pipe.scheduler.num_train_timesteps == 50 and pipe.unet.sample_size == 8
    convert.load_jax_params(pipe, jax.device_get(jp.params))
    (j_tg, j_in), (p_tg, p_in) = _cams()
    rng = np.random.default_rng(25)
    init = rng.uniform(-1, 1, size=(1, 3, 16, 16)).astype(np.float32)
    text = rng.normal(size=(1, 2, 8)).astype(np.float32)
    key = jax.random.PRNGKey(26)
    ref = jp(jnp.asarray(init), j_tg, j_in, jnp.zeros((1, 2, 3, 16, 16)),
             text_embeds=jnp.asarray(text), num_inference_steps=4, strength=0.5, key=key)
    eps, noise = _jax_draws(key, (1, 4, 8, 8))  # VAE_CFG downsamples once
    got = pipe(t(init), p_tg, p_in, torch.zeros((1, 2, 3, 16, 16)), text_embeds=t(text),
               num_inference_steps=4, strength=0.5, eps=eps, noise=noise)
    close(got, ref, PIPE_TOL)


def test_surplus_unet_channels_enable_feature_conditioning(tmp_path, caplog):
    cfg = dict(UNET_CFG, in_channels=4 + 5 + 3)
    _write_pipeline_dir(str(tmp_path), cfg, 27)
    with caplog.at_level(logging.WARNING):
        pipe = TinysplatDiffusionPipeline.from_pretrained(str(tmp_path), device="cpu")
    assert "leaves 5 channels beyond latents+xyz" in caplog.text
    assert pipe.feature_encoder.num_channels == 5 and pipe.feature_encoder.sample_size == 16
    (_, _), (p_tg, p_in) = _cams()
    out = pipe(torch.zeros((1, 3, 16, 16)), p_tg, p_in, torch.zeros((1, 2, 3, 16, 16)),
               num_inference_steps=2, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 3, 16, 16) and torch.isfinite(out).all()
