"""The loss layer's SSIM as two hand-written kernels: L1 and its backward L2.

Counterpart of the JAX package's SSIM (``tinysplat_tpu/ops/ssim.py``), which
XLA runs as banded matrix products: no Pallas kernel. pytorch_msssim's
semantics: an 11-tap Gaussian window (sigma 1.5), *valid* filtering, the map
``l * cs`` of the window moments mu_x, mu_y, e_xx, e_yy, e_xy. Images are
(N, H, W, C), the map (N, H - taps + 1, W - taps + 1, C).

- ``ssim_fwd``: L1 (``csrc/ssim.cu``) on CUDA float32 tensors: the map and,
  when asked, the map's partials by the moments that the backward needs;
  ``ssim_fwd_plain`` on CPU tensors: the moments by depthwise convolutions
  (``blur``), then the same expressions in torch ops.
- ``ssim_bwd``: L2 on CUDA float32 tensors: one image's gradient from the
  upstream map gradient (any tensor, not only the mean's constant) and the
  partials; ``ssim_bwd_plain`` on CPU tensors: the products of the two
  blurred back by transposed convolutions (``blur_adjoint``), combined at
  each pixel. Both plain versions are the hand-derived backward, not
  autograd.
- ``fused_ssim_maps``: both bound by a ``torch.autograd.Function``.

Both kernels are bound by the bytes they move (``layer_bytes``); the window
reaches them by value, as a launch argument, so nothing is uploaded and the
host never waits. Every wrapper launches its kernel on CUDA tensors (counted
in ``_build.launches``) or raises; CPU tensors run the plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import op_range, span
from . import _build

# The most window taps and the image channels the kernels take (RGB).
TAPS, CHANNELS = 11, 3
# The partials' planes: dS/dmu_x, dS/de_xx (= dS/de_yy), dS/de_xy, and with
# img2's gradient dS/dmu_y.
MU_X, E_XX, E_XY, MU_Y = range(4)
# L1 / L2 against their plain versions on the card: the map to TOL absolute,
# the gradients to TOL x their max |plain|. The window sums run in another
# order (a horizontal then a vertical pass of fused multiply-adds against
# cuDNN's vertical then horizontal convolutions), an ulp or so of each
# moment. sigma = e - mu^2 cancels that up relative to the variance, so the
# bar holds where the images vary; on a rendered frame's smooth dark patches
# float32 itself is 2.9e-4 off the exact (float64) map (the plain version,
# measured on an H100 at 1600x1066), and each version as far.
TOL = 1e-5


@functools.lru_cache(maxsize=8)
def gaussian_window(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@contextlib.contextmanager
def _cudnn_without_tf32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _taps(window: torch.Tensor, c: int):
    wv = window.reshape(1, 1, -1, 1).expand(c, 1, -1, 1).contiguous()
    wh = window.reshape(1, 1, 1, -1).expand(c, 1, 1, -1).contiguous()
    return wv, wh


def blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Valid-mode separable blur of (B, C, H, W) by a (size,) window: a
    vertical then a horizontal depthwise pass, in full float32 (cuDNN's
    TF32 off)."""
    c = x.shape[1]
    wv, wh = _taps(window, c)
    with _cudnn_without_tf32():
        return F.conv2d(F.conv2d(x, wv, groups=c), wh, groups=c)


def blur_adjoint(g: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``blur``: its transposed convolutions, (B, C, H', W')
    -> (B, C, H' + size - 1, W' + size - 1)."""
    c = g.shape[1]
    wv, wh = _taps(window, c)
    with _cudnn_without_tf32():
        return F.conv_transpose2d(F.conv_transpose2d(g, wh, groups=c), wv, groups=c)


class _Blur(torch.autograd.Function):
    """``blur`` with ``blur_adjoint`` as its backward."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.save_for_backward(window)
        return blur(x, window)

    @staticmethod
    def backward(ctx, g):
        (window,) = ctx.saved_tensors
        return blur_adjoint(g, window), None


def ssim_fwd_plain(x, y, window: np.ndarray, c1: float, c2: float, n_partials: int = 0):
    """L1 in plain PyTorch: (map, partials or None) of (N, H, W, C) images.

    The five moments come from one ``blur`` of the stacked channels x, y,
    x*x, y*y, x*y; the map is ``l * cs``. ``n_partials`` 3 adds the planes
    (3, N, H', W', C) of dS/dmu_x, dS/de_xx (= dS/de_yy) and dS/de_xy; 4
    adds dS/dmu_y.
    """
    w = torch.as_tensor(window, dtype=x.dtype, device=x.device)
    xc, yc = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    stacked = torch.cat([xc, yc, xc * xc, yc * yc, xc * yc], dim=1)
    mu_x, mu_y, e_xx, e_yy, e_xy = blur(stacked, w).permute(0, 2, 3, 1).chunk(5, dim=-1)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = e_xx - mu_xx
    sigma_yy = e_yy - mu_yy
    sigma_xy = e_xy - mu_xy
    b1 = mu_xx + mu_yy + c1
    b2 = sigma_xx + sigma_yy + c2
    cs = (2 * sigma_xy + c2) / b2
    lum = (2 * mu_xy + c1) / b1
    smap = lum * cs
    if not n_partials:
        return smap, None
    d_xx = -(smap / b2)
    d_xy = 2 * (lum / b2)
    # dS/dmu_x = u mu_y + v mu_x: the luminance term and sigma's -mu^2.
    u = 2 * (cs / b1) - d_xy
    v = -2 * (d_xx + smap / b1)
    planes = [u * mu_y + v * mu_x, d_xx, d_xy]
    if n_partials == 4:
        planes.append(u * mu_x + v * mu_y)
    return smap, torch.stack(planes)


def ssim_bwd_plain(g, p_mu, p_xx, p_xy, self, other, window: np.ndarray):
    """L2 in plain PyTorch: the gradient of ``self`` (N, H, W, C) from the
    map's upstream gradient ``g`` (N, H', W', C), the partials of ``self``'s
    mean (``p_mu``), of e_xx and of e_xy, and the other image:
    B*(g p_mu) + 2 self B*(g p_xx) + other B*(g p_xy), B* = ``blur_adjoint``."""
    w = torch.as_tensor(window, dtype=g.dtype, device=g.device)
    q = torch.cat([g * p_mu, g * p_xx, g * p_xy], dim=-1).permute(0, 3, 1, 2)
    a_mu, a_xx, a_xy = blur_adjoint(q, w).permute(0, 2, 3, 1).chunk(3, dim=-1)
    return a_mu + 2 * self * a_xx + other * a_xy


def _check(x, y):
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"SSIM takes two (N, H, W, C) images of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.device != y.device or x.dtype != y.dtype:
        raise ValueError(f"SSIM's images differ: {x.dtype} on {x.device}, {y.dtype} on "
                         f"{y.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"SSIM runs on CUDA or CPU tensors, not {x.device}")


def _cuda_ok(x, window: np.ndarray):
    """Raises on what L1 and L2 do not take."""
    n, h, w, c = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"the SSIM kernels take float32 images, got {x.dtype}")
    if c != CHANNELS:
        raise ValueError(f"the SSIM kernels take {CHANNELS} channels, got {c}")
    if not 1 <= len(window) <= TAPS or min(h, w) < len(window):
        raise ValueError(f"the SSIM kernels take a window of 1-{TAPS} taps no larger than "
                         f"the image, got {len(window)} taps over {h} x {w}")


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
# The C signature of each kernel's entry point; the CUDA stream comes last.
_SIGNATURES = {
    # x, y, n, h, w, c, window, taps, c1, c2, map, partials, n_partials, stream
    "ssim_fwd": (_P, _P) + (_I,) * 4 + (_P, _I, _F, _F, _P, _P, _I, _P),
    # g, g strides (image, map row, map float), p_mu, p_xx, p_xy, self, other,
    # n, h, w, c, window, taps, grad, stream
    "ssim_bwd": (_P,) + (_L,) * 3 + (_P,) * 5 + (_I,) * 4 + (_P, _I, _P, _P),
}


def _launch(symbol: str, device, *args) -> None:
    # An operator range of its own, so a trace counts the kernel inside the
    # caller's span (``ts.ssim``, ``ts.ssim.backward``).
    with op_range(symbol):
        _build.launch("ssim", _SIGNATURES[symbol], device, *args, symbol=symbol)


def _host_window(window: np.ndarray):
    """The window's floats in host memory: the entry points copy them into
    the launch's arguments. One array a window, kept."""
    return _window_floats(np.asarray(window, np.float32).tobytes())


@functools.lru_cache(maxsize=8)
def _window_floats(raw: bytes):
    return (ctypes.c_float * (len(raw) // 4)).from_buffer_copy(raw)


def ssim_fwd(x, y, window: np.ndarray, c1: float, c2: float, n_partials: int = 0):
    """SSIM's map of the (N, H, W, C) images ``x`` and ``y`` and, with
    ``n_partials`` 3 or 4, the partials ``ssim_fwd_plain`` gives.

    Launches L1 on CUDA tensors (``_build.launches["ssim_fwd"]`` counts
    the launches) and runs ``ssim_fwd_plain`` on CPU tensors."""
    _check(x, y)
    if n_partials not in (0, 3, 4):
        raise ValueError(f"n_partials must be 0, 3 or 4, got {n_partials}")
    if x.device.type == "cpu":
        return ssim_fwd_plain(x, y, window, c1, c2, n_partials)
    _cuda_ok(x, window)
    n, h, w, c = x.shape
    taps = len(window)
    x, y = x.contiguous(), y.contiguous()
    smap = x.new_empty((n, h - taps + 1, w - taps + 1, c))
    partials = x.new_empty((n_partials,) + tuple(smap.shape) if n_partials else (1,))
    _launch("ssim_fwd", x.device, x.data_ptr(), y.data_ptr(), n, h, w, c, _host_window(window),
            taps, c1, c2, smap.data_ptr(), partials.data_ptr(), n_partials)
    return smap, partials if n_partials else None


def ssim_bwd(g, p_mu, p_xx, p_xy, self, other, window: np.ndarray):
    """The gradient of ``self`` (N, H, W, C), as ``ssim_bwd_plain`` gives it.

    Launches L2 on CUDA tensors (``_build.launches["ssim_bwd"]`` counts
    the launches) and runs ``ssim_bwd_plain`` on CPU tensors. ``g`` may
    have any strides (a broadcast is read in place); the partials are the
    planes of ``ssim_fwd``'s."""
    _check(self, other)
    if self.device.type == "cpu":
        return ssim_bwd_plain(g, p_mu, p_xx, p_xy, self, other, window)
    _cuda_ok(self, window)
    n, h, w, c = self.shape
    taps = len(window)
    shape = (n, h - taps + 1, w - taps + 1, c)
    for name, t in (("g", g), ("p_mu", p_mu), ("p_xx", p_xx), ("p_xy", p_xy)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != self.device:
            raise ValueError(f"{name} must be float32 {shape} on {self.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if g.stride(2) != c * g.stride(3):  # L2 steps through a row's floats by one stride
        g = g.contiguous()
    parts = [t.contiguous() for t in (p_mu, p_xx, p_xy, self, other)]
    grad = torch.empty_like(parts[3])
    _launch("ssim_bwd", self.device, g.data_ptr(), g.stride(0), g.stride(1), g.stride(3),
            *(t.data_ptr() for t in parts), n, h, w, c, _host_window(window), taps,
            grad.data_ptr())
    return grad


def layer_bytes(n: int, h: int, w: int, c: int, taps: int = TAPS, n_partials: int = 3):
    """(L1's bytes, L2's bytes) at n (h, w, c) images: each input read once
    and each output written once. L1 reads both images and writes the map
    and ``n_partials`` planes; L2 reads the upstream gradient, three planes
    and both images and writes one gradient."""
    pixels, positions = n * h * w * c, n * (h - taps + 1) * (w - taps + 1) * c
    return 4 * (2 * pixels + (1 + n_partials) * positions), 4 * (4 * positions + 3 * pixels)


class _SSIM(torch.autograd.Function):
    """L1 forward; backward = L2 for each image that needs a gradient."""

    @staticmethod
    def forward(ctx, img1, img2, window, c1, c2):
        n_partials = 4 if ctx.needs_input_grad[1] else 3
        smap, partials = ssim_fwd(img1, img2, window, c1, c2, n_partials)
        ctx.save_for_backward(img1, img2, partials)
        ctx.window = window
        return smap

    @staticmethod
    def backward(ctx, g):
        with span("ts.ssim.backward"):
            img1, img2, partials = ctx.saved_tensors
            g1 = g2 = None
            if ctx.needs_input_grad[0]:
                g1 = ssim_bwd(g, partials[MU_X], partials[E_XX], partials[E_XY], img1, img2,
                              ctx.window)
            if ctx.needs_input_grad[1]:
                g2 = ssim_bwd(g, partials[MU_Y], partials[E_XX], partials[E_XY], img2, img1,
                              ctx.window)
            return g1, g2, None, None, None


def fused_ssim_maps(img1, img2, window: np.ndarray, c1: float, c2: float) -> torch.Tensor:
    """``ssim_fwd``'s map with L2 as its backward, for both images (the
    partials are written only where a gradient will be taken)."""
    if torch.is_grad_enabled() and (img1.requires_grad or img2.requires_grad):
        return _SSIM.apply(img1, img2, window, c1, c2)
    return ssim_fwd(img1, img2, window, c1, c2)[0]
