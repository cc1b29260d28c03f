"""The port's prior tools against the JAX package's scripts, part 3:
``train_diffusion_prior`` and ``diffusion_ab`` on the CPU.

Both packages' GT renders of the synthetic scene are replaced by one
closed-form image per camera (``fake_frame``: a pattern of the camera's
view matrix; the GT render path is held in test_torch_port_quality.py,
and the plain kernel walks ~15,000 entries a tile at these sizes): what is
held here is what each tool does with the frames.

- ``train_diffusion_prior``: 3 VAE and 3 denoiser steps at latent size 4
  (32x32 images), batch 2, 6 views. The starting weights are the port's
  ``tiny()`` draw, carried to JAX's pipeline through ``diffusion/convert.py``
  (JAX's own flax init is never run: it costs ~85 s cold); JAX's draws (the
  VAE eps, the timesteps, the noise, the dropout mask, from its key chain)
  are handed over (``JaxDraws``); the batch indices are numpy draws, equal
  already. Per-step losses within rtol 1e-4 (measured 2.5e-6); the weights
  after the steps as ``_assert_weights_close`` says (1e-5 x max for the VAE,
  1e-4 x max for the denoiser, where the gradient is clear of rounding);
  each package loads the native checkpoint the other wrote.
- ``diffusion_ab``: with ``Trainer`` stubbed in both scripts, the two arms'
  Configs, inits and camera splits are equal; a 4-step port run per arm at
  32x32 against a native tiny prior (one refresh at step 1) prints the JSON
  line with the JAX script's keys.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.diffusion import pipeline as jpipe

from tinysplat_torch.diffusion import convert, flax_msgpack
from tinysplat_torch.diffusion.pipeline import TinysplatDiffusionPipeline
from tinysplat_torch.scripts import diffusion_ab, train_diffusion_prior as tdp

from tests.test_torch_port_quality import (
    _recording_trainer, jax_json_keys, jax_script, run_jax_main)
from tests.test_torch_port_trainer import _two_torch_threads  # noqa: F401 (autouse)

LOSS_RTOL, WEIGHT_TOL, DENOISER_TOL = 1e-4, 1e-5, 1e-4
PRIOR = ["--views", "6", "--sample-size", "4", "--batch", "2", "--vae-steps", "3",
         "--unet-steps", "3"]


def fake_frame(xp, viewmat, h, w):
    """An (h, w, 3) frame in (0.1, 0.9) that differs from camera to camera."""
    y = xp.arange(h, dtype=xp.float32)[:, None, None]
    x = xp.arange(w, dtype=xp.float32)[None, :, None]
    c = xp.arange(3, dtype=xp.float32)[None, None, :]
    return 0.5 + 0.4 * xp.sin(0.31 * x * (c + 1.0) + 0.17 * y + 3.0 * viewmat[0, 3]
                              + 2.0 * viewmat[2, 3])


def _fake_jax_render(params, alive, cam, h, w, *args, **kwargs):
    zero = jnp.zeros((), jnp.int32)
    return fake_frame(jnp, cam.viewmat, h, w), {
        "depth": jnp.zeros((h, w)), "binning": {"dup_dropped": zero, "tile_dropped": zero}}


def _fake_gt_renderer(gt_state, sh_degree, rasterizer, **budgets):
    def render_gt(cam_params, h, w):
        return fake_frame(torch, cam_params.viewmat, h, w), torch.zeros((h, w)), 0

    return render_gt


def _fake_gt(monkeypatch):
    """Both packages' GT renders replaced by ``fake_frame``."""
    import sys

    monkeypatch.setattr(sys.modules["tinysplat_tpu.render"], "render", _fake_jax_render)
    monkeypatch.setattr(tdp, "gt_renderer", _fake_gt_renderer)
    monkeypatch.setattr(diffusion_ab, "gt_renderer", _fake_gt_renderer)


class JaxDraws:
    """The JAX script's draws from its key chain (PRNGKey(seed + 1), one
    split per step), in the port's NCHW layout."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed + 1)

    def _next(self):
        self.key, k1 = jax.random.split(self.key)
        return k1

    @staticmethod
    def _nchw_normal(key, shape):
        b, c, h, w = shape  # the VAE draws its eps in NHWC
        return torch.from_numpy(np.array(jax.random.normal(key, (b, h, w, c)))).permute(
            0, 3, 1, 2).contiguous()

    def vae_eps(self, shape):
        return self._nchw_normal(self._next(), shape)

    def denoiser(self, shape, num_timesteps, dropout):
        kz, kt, ke, kd = jax.random.split(self._next(), 4)
        b = shape[0]
        t = torch.from_numpy(np.array(jax.random.randint(kt, (b,), 0, num_timesteps))).long()
        noise = torch.from_numpy(np.array(jax.random.normal(ke, shape)))
        drop = torch.from_numpy(np.array(jax.random.uniform(kd, (b, 1, 1, 1)) < dropout))
        return self._nchw_normal(kz, shape), t, noise, drop


def _port_weights(pipe):
    return {k: convert.tiny_flax_variables(m) for k, m in pipe.parts().items()}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _assert_trees_close(got, ref, tol, what):
    ref_leaves = dict(_leaves(ref))
    got_leaves = dict(_leaves(got))
    assert got_leaves.keys() == ref_leaves.keys(), what
    for path, r in ref_leaves.items():
        scale = max(float(np.abs(r).max()), 1e-12)
        np.testing.assert_allclose(got_leaves[path], r, rtol=0, atol=tol * scale,
                                   err_msg=f"{what}: {'/'.join(path)}")


def _adam_state(pipe, optimizers, steps):
    """Per flax path of the port's trained weights: (first moment, the
    bias-corrected Adam ratio m / sqrt(v)) after ``steps`` steps."""
    out = {}
    for part, mod in pipe.parts().items():
        opt = optimizers["vae" if part == "vae" else "denoiser"]
        for path, p in convert._walk(mod):
            st = opt.state[p]
            m, v = st["exp_avg"], st["exp_avg_sq"]
            ratio = (m / (1 - 0.9 ** steps)) / (v / (1 - 0.999 ** steps)).sqrt().clamp(min=1e-30)
            out[(part, "params") + path] = tuple(convert._to_flax_layout(path[-1], x.numpy())
                                                 for x in (m, ratio))
    return out


def _assert_weights_close(history, jax_trained, start):
    """Adam normalizes each gradient: where a gradient is rounding residue
    (a bias in front of a GroupNorm, an attention key bias, the embedding
    MLP's kernel on zero inputs: zero in exact arithmetic), each package
    steps it by +-lr at random, and where a gradient's sign turns, the
    step's size rides on the gradients' rounding. So every weight is held
    within 1e-6 + 2 lr a step of JAX's, and the weights whose first moment
    is clear of rounding (|m| >= 1e-2 x the part's max) and whose steps
    kept their sign (|m / sqrt(v)| >= 0.5, bias-corrected) within
    WEIGHT_TOL x the part's max |weight| (the VAE) and DENOISER_TOL x
    (the denoiser's parts, measured 5.5e-5 x in the UNet: one kernel entry
    whose update ratio fell to 0.82 over the 3 steps)."""
    steps = 3
    adam = _adam_state(history["pipeline"], history["optimizers"], steps)
    got = dict(_leaves(_port_weights(history["pipeline"])))
    ref = dict(_leaves(jax_trained))
    assert got.keys() == ref.keys() == adam.keys()
    start = dict(_leaves(start))
    moved = 0.0
    for part in {k[0] for k in ref}:
        keys = [k for k in ref if k[0] == part]
        w_max = max(float(np.abs(ref[k]).max()) for k in keys)
        m_max = max(float(np.abs(adam[k][0]).max()) for k in keys)
        lr = 2e-3 if part == "vae" else 1e-3
        tol = WEIGHT_TOL if part == "vae" else DENOISER_TOL
        clear_share = []
        for k in keys:
            diff = np.abs(got[k] - ref[k])
            assert diff.max() <= 1e-6 + 2 * lr * steps, k
            m, ratio = adam[k]
            clear = (np.abs(m) >= 1e-2 * m_max) & (np.abs(ratio) >= 0.5)
            if clear.any():
                assert diff[clear].max() <= tol * w_max, ("/".join(k), diff[clear].max() / w_max)
            clear_share.append((clear.sum(), clear.size))
            moved = max(moved, float(np.abs(ref[k] - start[k]).max()))
        share = sum(a for a, _ in clear_share) / sum(b for _, b in clear_share)
        assert share > (0.002 if part == "em" else 0.25), (part, share)
    assert moved > 1e-3  # the steps moved the weights


@pytest.fixture
def jax_losses(monkeypatch):
    """Every loss the JAX script's jitted steps compute, in order: its
    ``jax.value_and_grad`` records the value through a debug callback."""
    losses = []
    real = jax.value_and_grad

    def value_and_grad(fn, *args, **kwargs):
        vg = real(fn, *args, **kwargs)

        def run(*a, **k):
            out = vg(*a, **k)
            val = out[0][0] if kwargs.get("has_aux") else out[0]
            jax.debug.callback(lambda v: losses.append(float(v)), val, ordered=True)
            return out

        return run

    monkeypatch.setattr(jax, "value_and_grad", value_and_grad)
    return losses


def test_train_diffusion_prior_matches_jax(tmp_path, capsys, monkeypatch, jax_losses):
    _fake_gt(monkeypatch)
    start = TinysplatDiffusionPipeline.tiny(sample_size=4,
                                            generator=torch.Generator().manual_seed(0),
                                            device="cpu")
    weights = _port_weights(start)
    monkeypatch.setattr(jpipe.TinysplatDiffusionPipeline, "init_params",
                        staticmethod(lambda *a: jax.tree.map(jnp.asarray, weights)))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with jax_script("train_diffusion_prior", monkeypatch) as jtdp:
        ref = run_jax_main(jtdp, PRIOR + ["--out-dir", jdir], capsys, monkeypatch)
    jax_vae, jax_dn = jax_losses[:3], jax_losses[3:]
    monkeypatch.undo()  # the port's steps must not go through the recorder
    _fake_gt(monkeypatch)
    history = {}
    got = tdp.main(PRIOR + ["--out-dir", pdir, "--device", "cpu"], draws=JaxDraws(0),
                   history=history)
    assert set(got) == set(ref) == {"metric", "value", "out_dir"}
    assert got["value"] is ref["value"] is None  # no loss logged before step 500
    assert len(jax_vae) == len(jax_dn) == 3
    np.testing.assert_allclose(history["vae_loss"], jax_vae, rtol=LOSS_RTOL)
    np.testing.assert_allclose(history["denoiser_loss"], jax_dn, rtol=LOSS_RTOL)
    assert history["vae_loss"] != [float(x) for x in jax_dn]  # two phases, two objectives

    with open(os.path.join(jdir, "params.msgpack"), "rb") as f:
        jax_trained = flax_msgpack.from_bytes(f.read())
    _assert_weights_close(history, jax_trained, weights)

    # Each package loads the other's native checkpoint.
    for name in ("config.json", "training.json"):
        with open(os.path.join(jdir, name)) as a, open(os.path.join(pdir, name)) as b:
            assert a.read() == b.read(), name
    from_jax = TinysplatDiffusionPipeline.load_native(jdir, device="cpu")
    _assert_trees_close(_port_weights(from_jax), jax_trained, 0.0, "port loads JAX's")
    monkeypatch.setattr(jpipe.TinysplatDiffusionPipeline, "init_params",
                        staticmethod(lambda *a: jax.tree.map(jnp.asarray, weights)))
    from_port = jpipe.TinysplatDiffusionPipeline.load_native(pdir)
    _assert_trees_close(jax.device_get(from_port.params), _port_weights(history["pipeline"]),
                        0.0, "JAX loads the port's")


def test_diffusion_ab_arms_match_jax(tmp_path, capsys, monkeypatch):
    import tinysplat_tpu.train_loop as jtl

    _fake_gt(monkeypatch)
    flags = ["--prior-dir", str(tmp_path / "prior"), "--size", "32", "--iters", "160",
             "--diffusion-start", "40", "--init-points", "200", "--capacity", "512"]
    jlog, plog = [], []
    monkeypatch.setattr(jtl, "Trainer", _recording_trainer(jlog, jnp))
    with jax_script("diffusion_ab", monkeypatch) as jab:
        ref = run_jax_main(jab, flags + ["--out", str(tmp_path / "jax.json")], capsys,
                           monkeypatch)
    monkeypatch.setattr(diffusion_ab, "Trainer", _recording_trainer(plog, torch))
    got = diffusion_ab.main(flags + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    assert len(plog) == len(jlog) == 2
    for pt, jt in zip(plog, jlog):
        # The port's own option at its default.
        assert dataclasses.asdict(pt.cfg) == dict(dataclasses.asdict(jt.cfg), mcmc_refine_every=0)
        assert [c.name for c in pt.scene.cameras] == [c.name for c in jt.scene.cameras]
        assert [c.name for c in pt.eval_cameras] == [c.name for c in jt.eval_cameras]
        assert pt.scene.seed == jt.scene.seed == 0
        assert pt.calls == jt.calls == [160]
        np.testing.assert_array_equal(pt.state.params.means.numpy(),
                                      np.asarray(jt.state.params.means))
        np.testing.assert_array_equal(pt.state.params.colors_dc.numpy(),
                                      np.asarray(jt.state.params.colors_dc))
    plain, guided = plog[0].cfg, plog[1].cfg
    assert (plain.regularize_diffusion, guided.regularize_diffusion) == (False, True)
    assert (guided.regularize_diffusion_start, guided.regularize_diffusion_end,
            guided.interval_diffusion) == (40, 133, 400)
    assert [c.name for c in plog[0].scene.cameras] == [
        f"synthetic_{i:03d}" for i in range(0, 12, 2)]
    assert set(got) == set(ref) == jax_json_keys("diffusion_ab")
    varying = ("plain", "guided", "value")
    assert {k: v for k, v in got.items() if k not in varying} == \
        {k: v for k, v in ref.items() if k not in varying}


def test_diffusion_ab_runs_on_the_cpu(tmp_path, monkeypatch):
    _fake_gt(monkeypatch)
    prior = str(tmp_path / "prior")
    TinysplatDiffusionPipeline.tiny(sample_size=4, device="cpu").save_native(prior)
    out = tmp_path / "ab.json"
    history = {}
    got = diffusion_ab.main(["--device", "cpu", "--prior-dir", prior, "--size", "32",
                             "--iters", "4", "--diffusion-start", "1", "--init-points", "200",
                             "--capacity", "512", "--out", str(out)], history=history)
    assert set(got) == jax_json_keys("diffusion_ab")
    assert out.exists() and got["resolution"] == [32, 32]
    for arm in ("plain", "guided"):
        assert np.isfinite(got[arm]["eval_psnr"]) and history[arm].step == 4
    assert history["plain"]._diffusion_guidance is None
    guidance = history["guided"]._diffusion_guidance
    assert guidance is not None and guidance.size == 32
    assert got["value"] == round(got["guided"]["eval_psnr"] - got["plain"]["eval_psnr"], 2)
