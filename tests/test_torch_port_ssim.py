"""Port SSIM / PSNR vs the JAX package's (``tinysplat_tpu.ops.ssim``).

Same numpy-drawn images into both; values, maps and gradients to 1e-5
(the blur sums in another order: the JAX package contracts with banded
matrices, the port convolves).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.ops import ssim as jssim

from tinysplat_torch.ops import ssim as tssim
from tinysplat_torch.ops import ssim_cuda

from tests._torch_threads import one_torch_thread  # noqa: F401


def _pair(h, w, noise, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("h,w,noise", [(40, 52, 0.1), (11, 11, 0.3), (33, 64, 0.02)])
def test_ssim_and_psnr_match_jax(h, w, noise):
    a, b = _pair(h, w, noise, seed=h)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    smap = tssim.ssim_map(ta, tb)
    assert smap.shape == (h - 10, w - 10, 3)
    np.testing.assert_allclose(smap.numpy(), np.asarray(jssim.ssim_map(ja, jb)), atol=1e-5)
    np.testing.assert_allclose(float(tssim.ssim(ta, tb)), float(jssim.ssim(ja, jb)),
                               atol=1e-5)
    np.testing.assert_allclose(float(tssim.psnr(ta, tb)), float(jssim.psnr(ja, jb)),
                               atol=1e-5, rtol=1e-6)
    assert float(tssim.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)


def test_ssim_gradient_matches_jax():
    a, b = _pair(36, 44, 0.1, seed=3)
    ref = np.asarray(jax.grad(lambda x: jssim.ssim(x, jnp.asarray(b)))(jnp.asarray(a)))
    ta = torch.from_numpy(a).requires_grad_()
    tssim.ssim(ta, torch.from_numpy(b)).backward()
    np.testing.assert_allclose(ta.grad.numpy(), ref, atol=1e-5 * np.abs(ref).max())


def test_blur_backward_is_the_adjoint_and_restores_tf32_flag():
    """The blur's hand-written backward (transposed convolutions) against
    numerical differentiation, in float64; cuDNN's TF32 flag is as before."""
    flag = torch.backends.cudnn.allow_tf32
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, 2, 14, 17))).requires_grad_()
    window = torch.from_numpy(ssim_cuda.gaussian_window(5, 1.5).astype(np.float64))
    assert torch.autograd.gradcheck(lambda t: ssim_cuda._Blur.apply(t, window), (x,))
    assert torch.backends.cudnn.allow_tf32 == flag
