"""SuGaR's density term as two hand-written kernels: ``density_fwd`` and its
backward ``density_bwd`` (``csrc/density.cu``).

Counterpart of the JAX package's ``density_loss``
(``tinysplat_tpu/regularizers/density.py``), plain ``jnp`` that XLA fuses:
no Pallas kernel. The plain version is the torch-op chain of
``regularizers/density.density_loss`` (``density_at_points``,
``probe_beta``, ``approximate_density``, the masked mean), which runs CPU
tensors alone: on the card the kernels run every call, and their wrappers
refuse what they do not take.

- ``density_fwd``: the term's loss and the masked points' count (clamped to
  1) as two 0-d device tensors; 16 lanes gather a point's neighbour rows
  once, the mean comes from fixed-order block partials, so the loss repeats
  bit for bit and the host reads nothing.
- ``density_bwd``: from the upstream gradient and that count, both read
  on the device, the splats' gradient rows (N, 12) (``ROW``'s columns) and
  the depth map's gradient, by atomic adds into one zeroed buffer, and
  where asked the camera's (``pose_opt``): viewmat, projmat, cx_off and
  cy_off (``CAMERA``), from fixed-order block partials.
- ``fused_density_loss``: both bound by a ``torch.autograd.Function``; its
  backward runs inside the span ``ts.density.backward``.

Each wrapper checks what the kernels take (float32 rows of the stated widths,
contiguous; int64 neighbour indices; quaternions on a 16-byte boundary; a
(4, 4) camera) and raises on anything else, then launches on CUDA tensors
(counted in ``_build.launches``) or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import op_range, span
from . import _build

# Columns of a splat's gradient row in density_bwd's (N, ROW) output.
ROW = 12
MEANS, OPACITIES, QUATS, SCALES = slice(0, 3), slice(3, 4), slice(4, 8), slice(8, 11)
# Splat rows by field: (name, width).
SPLAT_FIELDS = (("means", 3), ("quats", 4), ("scales", 3), ("opacities", 1))
# Points a block of either kernel, so its partials' count.
POINTS_PER_BLOCK = 16
# The camera's gradient row: (name, floats) in order.
CAMERA = (("viewmat", 16), ("projmat", 16), ("cx_off", 1), ("cy_off", 1))
CAM_ROW = 34
# The kernels against the plain version in float64 (the card tests, the
# smoke's phase 10): the loss within TOL_LOSS (relative), each gradient
# within TOL_GRAD x its largest |entry|, or within TOL_RATIO x the plain
# float32 version's own gap where that is wider (float32 itself: the depth
# path divides by beta^2, sdf_hat = depth - z cancels, and the camera's
# gradient sums every point's). Both kernels take the plain version's
# float32 ops in its order, so they stand about as far from float64 as it
# does; the atomics add a row's pieces in any order, (m - 1) 2^-24 of their
# |sum| for m pairs.
TOL_LOSS, TOL_GRAD, TOL_RATIO = 1e-5, 2e-4, 4.0


def within_tol(gaps) -> bool:
    """Whether the kernels' gaps {name: (kernels, plain float32)} to the
    float64 plain version ("loss" relative, a gradient over its largest
    |entry|) are within the bounds above."""
    return all(k <= max(TOL_LOSS if name == "loss" else TOL_GRAD, TOL_RATIO * p)
               for name, (k, p) in gaps.items())


class TermInputs(NamedTuple):
    """What both kernels read: the probe, the splats' rows, the rendered
    depth (any strides) and the camera."""

    points: torch.Tensor  # (S, 3)
    knn_idx: torch.Tensor  # (S, K) int64
    means: torch.Tensor  # (N, 3)
    quats: torch.Tensor  # (N, 4)
    scales: torch.Tensor  # (N, 3)
    opacities: torch.Tensor  # (N, 1)
    depth_map: torch.Tensor  # (H, W)
    viewmat: torch.Tensor  # (4, 4)
    projmat: torch.Tensor  # (4, 4)
    cx_off: torch.Tensor  # one float
    cy_off: torch.Tensor
    img_height: int
    img_width: int
    use_sdf: bool


def term_inputs(probe, params, depth_map, camera, img_height: int, img_width: int,
                use_sdf: bool) -> TermInputs:
    return TermInputs(probe.points, probe.knn_idx, params.means, params.quats, params.scales,
                      params.opacities, depth_map, camera.viewmat, camera.projmat,
                      camera.cx_off, camera.cy_off, int(img_height), int(img_width),
                      bool(use_sdf))


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def takes_kernels(probe, params, depth_map, camera) -> bool:
    """Whether ``density_loss`` runs the kernels: any of its tensors on the
    card. The plain torch ops run CPU tensors alone; on the card the
    wrappers raise on what the kernels do not take (another dtype, tensors
    on two devices)."""
    return any(_on_card(t) for t in (
        probe.points, probe.knn_idx, params.means, params.quats, params.scales,
        params.opacities, depth_map, camera.viewmat, camera.projmat, camera.cx_off,
        camera.cy_off))


def _need(name: str, t: torch.Tensor, shape: Optional[tuple], dtype=torch.float32) -> None:
    """Raises unless ``t`` has ``dtype`` and (where given) ``shape``, None
    there matching any width."""
    if t.dtype != dtype:
        raise TypeError(f"the density kernels take {name} as {dtype}, got {t.dtype}")
    if shape is not None and (t.dim() != len(shape) or any(
            w is not None and t.shape[i] != w for i, w in enumerate(shape))):
        raise ValueError(f"the density kernels take {name} of shape {shape} (None: any), "
                         f"got {tuple(t.shape)}")


def _one_float(name: str, t: torch.Tensor, device) -> None:
    _need(name, t, None)
    if t.numel() != 1 or t.device != device:
        raise ValueError(f"the density kernels take {name} as one float on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")


def _check(t: TermInputs) -> Tuple[int, int, int]:
    """Raises on what the kernels do not take; returns (S, K, N)."""
    _need("points", t.points, (None, 3))
    s = t.points.shape[0]
    _need("knn_idx", t.knn_idx, (s, None), torch.int64)
    k = t.knn_idx.shape[1]
    if k < 1:
        raise ValueError("the density kernels take at least one neighbour a point")
    n = t.means.shape[0] if t.means.dim() == 2 else -1
    for name, width in SPLAT_FIELDS:
        _need(name, getattr(t, name), (n, width))
    if not 0 < n < 2**31:
        raise ValueError(f"the density kernels take 1 to 2^31 - 1 splats, got {n}")
    _need("depth_map", t.depth_map, (None, None))
    if min(t.depth_map.shape) < 1:
        raise ValueError(f"the density kernels take a non-empty depth map, got "
                         f"{tuple(t.depth_map.shape)}")
    _need("viewmat", t.viewmat, (4, 4))
    _need("projmat", t.projmat, (4, 4))
    dev = t.points.device
    for name in ("cx_off", "cy_off"):
        _one_float(name, getattr(t, name), dev)
    rows = ("points", "knn_idx", "means", "quats", "scales", "opacities", "viewmat", "projmat")
    for name in rows:
        if not getattr(t, name).is_contiguous():
            raise ValueError(f"the density kernels take {name} contiguous")
    if t.quats.data_ptr() % 16:
        raise ValueError("the density kernels read a quaternion as 16 bytes: quats must "
                         "start on a 16-byte boundary")
    if any(getattr(t, name).device != dev for name in rows + ("depth_map",)):
        raise ValueError("the density kernels take every tensor on one device")
    if dev.type != "cuda":
        raise ValueError(f"the density kernels run on CUDA tensors, not {dev}")
    return s, k, n


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# points, idx, S, K, means, quats, scales, opac, n, depth, sy, sx, dh, dw, view,
# proj, cx_off, cy_off, img_h, img_w, use_sdf
_INPUTS = (_P, _P, _L, _I) + (_P,) * 4 + (_I, _P, _L, _L, _I, _I) + (_P,) * 4 + (_I,) * 3
# The C signature of each kernel's entry point; the CUDA stream comes last.
_SIGNATURES = {
    # ..., part_sum, part_count, loss, denom, stream
    "density_fwd": _INPUTS + (_P,) * 5,
    # ..., upstream, denom, rows, grad_depth, cam_part, cam_grad, stream
    "density_bwd": _INPUTS + (_P,) * 7,
}


def _args(t: TermInputs, s: int, k: int, n: int) -> tuple:
    d = t.depth_map
    return (t.points.data_ptr(), t.knn_idx.data_ptr(), s, k, t.means.data_ptr(),
            t.quats.data_ptr(), t.scales.data_ptr(), t.opacities.data_ptr(), n, d.data_ptr(),
            d.stride(0), d.stride(1), d.shape[0], d.shape[1], t.viewmat.data_ptr(),
            t.projmat.data_ptr(), t.cx_off.data_ptr(), t.cy_off.data_ptr(), t.img_height,
            t.img_width, int(t.use_sdf))


def _launch(symbol: str, device, *args) -> None:
    # An operator range of its own, so a trace counts the kernel inside the
    # caller's span.
    with op_range(symbol):
        _build.launch("density", _SIGNATURES[symbol], device, *args, symbol=symbol)


def density_fwd(t: TermInputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, the masked points' count clamped to 1), two 0-d float32 tensors
    on the device, as the plain ``density_loss`` gives the loss. Launches
    ``density_fwd`` (``_build.launches["density_fwd"]``)."""
    s, k, n = _check(t)
    dev = t.points.device
    blocks = max(1, -(-s // POINTS_PER_BLOCK))
    part_sum = torch.empty((blocks,), dtype=torch.float32, device=dev)
    part_count = torch.empty((blocks,), dtype=torch.int32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    denom = torch.empty((), dtype=torch.float32, device=dev)
    _launch("density_fwd", dev, *_args(t, s, k, n), part_sum.data_ptr(), part_count.data_ptr(),
            loss.data_ptr(), denom.data_ptr())
    return loss, denom


def density_bwd(g: torch.Tensor, denom: torch.Tensor, t: TermInputs, splats: bool = True,
                depth: bool = True, camera: bool = False
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(the splats' gradient rows (N, ``ROW``) or None, the depth map's
    gradient (H, W) or None, the camera's gradient row (``CAM_ROW``,
    ``CAMERA``'s fields) or None) of ``g`` x the loss, from the 0-d device
    tensors ``g`` and ``denom`` (``density_fwd``'s). Launches
    ``density_bwd`` (``_build.launches["density_bwd"]``) where any is asked
    for."""
    s, k, n = _check(t)
    _one_float("g", g, t.points.device)
    _one_float("denom", denom, t.points.device)
    if not (splats or depth or camera):
        return None, None, None
    dev = t.points.device
    dh, dw = t.depth_map.shape
    sizes = (n * ROW * splats, dh * dw * depth, CAM_ROW * camera)
    rows, grad_depth, cam = torch.zeros((sum(sizes),), dtype=torch.float32,
                                        device=dev).split(sizes)
    rows = rows.view(n, ROW) if splats else None
    grad_depth = grad_depth.view(dh, dw) if depth else None
    cam = cam if camera else None
    blocks = max(1, -(-s // POINTS_PER_BLOCK))
    cam_part = torch.empty((blocks * CAM_ROW,), dtype=torch.float32, device=dev) if camera else None
    _launch("density_bwd", dev, *_args(t, s, k, n), g.data_ptr(), denom.data_ptr(),
            *(x.data_ptr() if x is not None else None for x in (rows, grad_depth, cam_part, cam)))
    return rows, grad_depth, cam


def camera_grads(cam: torch.Tensor, t: TermInputs):
    """(viewmat, projmat, cx_off, cy_off) gradients: views of ``cam`` in the
    shapes of ``t``'s camera tensors."""
    parts = cam.split([w for _, w in CAMERA])
    return tuple(x.view(getattr(t, name).shape) for x, (name, _) in zip(parts, CAMERA))


def splat_grads(rows: torch.Tensor):
    """(means, quats, scales, opacities) gradients: views of ``rows``."""
    return rows[:, MEANS], rows[:, QUATS], rows[:, SCALES], rows[:, OPACITIES]


class _DensityTerm(torch.autograd.Function):
    """``density_fwd`` forward; backward = ``density_bwd`` into the splats'
    rows, the depth map and the camera, as far as each needs a gradient.
    Takes the fields of ``TermInputs`` in order."""

    @staticmethod
    def forward(ctx, *fields):
        t = TermInputs(*fields)
        loss, denom = density_fwd(t)
        ctx.save_for_backward(*t[:11], denom)
        ctx.dims = t[11:]
        return loss

    @staticmethod
    def backward(ctx, g):
        with span("ts.density.backward"):
            *tensors, denom = ctx.saved_tensors
            t = TermInputs(*tensors, *ctx.dims)
            # means, quats, scales, opacities, depth_map, viewmat, projmat, cx_off, cy_off
            need = ctx.needs_input_grad[2:11]
            rows, grad_depth, cam = density_bwd(g.to(torch.float32), denom, t,
                                                splats=any(need[:4]), depth=need[4],
                                                camera=any(need[5:]))
            grads = ((splat_grads(rows) if rows is not None else (None,) * 4) + (grad_depth,)
                     + (camera_grads(cam, t) if cam is not None else (None,) * 4))
            grads = tuple(x if n else None for x, n in zip(grads, need))
            return (None, None) + grads + (None,) * 3


def fused_density_loss(probe, params, depth_map, camera, img_height: int, img_width: int,
                       use_sdf: bool = False) -> torch.Tensor:
    """``density_loss`` through the two kernels (see ``takes_kernels``)."""
    return _DensityTerm.apply(*term_inputs(probe, params, depth_map, camera, img_height,
                                           img_width, use_sdf))
