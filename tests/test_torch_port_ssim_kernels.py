"""SSIM's plain versions (``ops/ssim_cuda.ssim_fwd_plain`` / ``ssim_bwd_plain``)
against the JAX package's SSIM and against autograd through the port's
earlier chain of torch ops.

The plain versions are what L1 and L2 (``csrc/ssim.cu``) are held to on the
card, and what every CPU caller runs: the backward is the hand-derived one
(the partials by the window moments, blurred back by the transposed
convolutions), not autograd. Shapes: a single 11x11 window, an odd width,
N = 3, and a band plus its 10-row halo as the mesh step's interleaved mode
stacks them (N = bands x groups). Maps to 1e-5; gradients to 1e-5 x the
reference's max (the blur sums in another order than JAX's banded matrix
products; against autograd through the same convolutions only the chain
rule's arithmetic differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.ops import ssim as jssim

from tinysplat_torch.ops import ssim as tssim
from tinysplat_torch.ops import ssim_cuda as sc

from tests._torch_threads import one_torch_thread  # noqa: F401

C1, C2 = 0.01**2, 0.03**2
SHAPES = {"11x11": (1, 11, 11), "odd width": (1, 29, 53), "N=3": (3, 24, 37),
          "band+halo": (4, 16 + 10, 48)}


def _pair(n, h, w, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 1).astype(np.float32)
    return a, b


def _upstream(kind, n, h, w, seed):
    """The map's upstream gradient: the mean's constant, or a random field
    (the mesh step's masked partial sums give a non-uniform one)."""
    shape = (n, h - 10, w - 10, 3)
    if kind == "mean":
        return np.full(shape, 1.0 / np.prod(shape), np.float32)
    return np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)


def _chain_maps(x, y):
    """The port's earlier SSIM: one blur of the stacked channels, the map by
    autograd-tracked torch ops (``_Blur``'s backward the transposed
    convolutions)."""
    window = torch.as_tensor(sc.gaussian_window(11, 1.5))
    xc, yc = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    stacked = torch.cat([xc, yc, xc * xc, yc * yc, xc * yc], dim=1)
    mu_x, mu_y, e_xx, e_yy, e_xy = sc._Blur.apply(stacked, window).chunk(5, dim=1)
    s_xx, s_yy, s_xy = e_xx - mu_x * mu_x, e_yy - mu_y * mu_y, e_xy - mu_x * mu_y
    cs = (2 * s_xy + C2) / (s_xx + s_yy + C2)
    smap = ((2 * mu_x * mu_y + C1) / (mu_x * mu_x + mu_y * mu_y + C1)) * cs
    return smap.permute(0, 2, 3, 1)


def _jax_grads(a, b, g):
    def f(x, y):
        return sum(jnp.sum(jssim.ssim_map(x[i], y[i]) * g[i]) for i in range(x.shape[0]))

    ga, gb = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(ga), np.asarray(gb)


def _close(got, ref, rel=1e-5):
    np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_map_matches_jax(name):
    n, h, w = SHAPES[name]
    a, b = _pair(n, h, w, seed=h + w)
    smap, partials = sc.ssim_fwd(torch.from_numpy(a), torch.from_numpy(b),
                                 sc.gaussian_window(11, 1.5), C1, C2)
    assert smap.shape == (n, h - 10, w - 10, 3) and partials is None
    ref = np.stack([np.asarray(jssim.ssim_map(jnp.asarray(a[i]), jnp.asarray(b[i])))
                    for i in range(n)])
    np.testing.assert_allclose(smap.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(tssim.ssim_maps(torch.from_numpy(a), torch.from_numpy(b)),
                                  smap)


@pytest.mark.parametrize("kind", ["mean", "random"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_gradients_match_autograd_and_jax(name, kind):
    """Both images' gradients through ``ssim_maps`` (the Function over the
    plain versions) against autograd through the earlier chain and against
    ``jax.grad``, under the mean's upstream gradient and a random one."""
    n, h, w = SHAPES[name]
    a, b = _pair(n, h, w, seed=3 * h + w)
    g = _upstream(kind, n, h, w, seed=h)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (a, b)]
    smap = tssim.ssim_maps(*leaves)
    got = torch.autograd.grad(smap, leaves, torch.from_numpy(g))
    chain = [torch.from_numpy(t).requires_grad_() for t in (a, b)]
    np.testing.assert_allclose(smap.detach().numpy(), _chain_maps(*chain).detach().numpy(),
                               atol=1e-6)
    ref = torch.autograd.grad(_chain_maps(*chain), chain, torch.from_numpy(g))
    for t, r in zip(got, ref):
        _close(t.numpy(), r.numpy())
    for t, r in zip(got, _jax_grads(a, b, g)):
        _close(t.numpy(), r)


@pytest.mark.parametrize("which", [0, 1])
def test_only_the_asked_gradient_and_its_partials(which):
    """With one image differentiable, the other gets no gradient; the
    forward writes dS/dmu_y only where img2's gradient is wanted."""
    a, b = (torch.from_numpy(t) for t in _pair(2, 20, 31, seed=5))
    leaves = [a.clone(), b.clone()]
    leaves[which].requires_grad_()
    seen = []
    fwd = sc.ssim_fwd

    def spy(*args):
        out = fwd(*args)
        seen.append(out[1].shape[0])
        return out

    sc.ssim_fwd = spy
    try:
        tssim.ssim_maps(*leaves).sum().backward()
    finally:
        sc.ssim_fwd = fwd
    assert seen == [3 if which == 0 else 4]
    assert leaves[which].grad is not None and leaves[1 - which].grad is None
    with torch.no_grad():
        assert not tssim.ssim_maps(*leaves).requires_grad


def test_plain_backward_is_the_adjoint_in_float64():
    """``ssim_bwd_plain`` against numerical differentiation of the plain
    forward, in float64, at a 7-tap window, both images."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(size=(1, 12, 15, 2))).requires_grad_()
    b = torch.from_numpy(rng.uniform(size=(1, 12, 15, 2))).requires_grad_()
    window = sc.gaussian_window(7, 1.5)
    assert torch.autograd.gradcheck(
        lambda x, y: sc.fused_ssim_maps(x, y, window, C1, C2), (a, b))


@pytest.mark.parametrize("bad", ["float64", "1 channel", "13 taps", "too small"])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(bad):
    x = torch.zeros((1, 20, 20, 3))
    window = sc.gaussian_window(11, 1.5)
    if bad == "float64":
        x = x.double()
    elif bad == "1 channel":
        x = torch.zeros((1, 20, 20, 1))
    elif bad == "13 taps":
        window = sc.gaussian_window(13, 1.5)
    else:
        x = torch.zeros((1, 10, 20, 3))
    with pytest.raises((TypeError, ValueError)):
        sc._cuda_ok(x, window)
    sc._cuda_ok(torch.zeros((2, 11, 11, 3)), sc.gaussian_window(11, 1.5))
    sc._cuda_ok(torch.zeros((2, 7, 7, 3)), sc.gaussian_window(7, 1.5))


def test_layer_bytes_count_each_input_and_output_once():
    fwd, bwd = sc.layer_bytes(1, 1066, 1600, 3)
    pixels, positions = 1066 * 1600 * 3, 1056 * 1590 * 3
    assert fwd == 4 * (2 * pixels + 4 * positions)
    assert bwd == 4 * (4 * positions + 3 * pixels)
    assert sc.layer_bytes(2, 20, 30, 1, n_partials=0)[0] == 4 * (2 * 1200 + 400)
