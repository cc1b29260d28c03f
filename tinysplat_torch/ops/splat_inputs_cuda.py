"""The splat-input layer as two hand-written kernels: S1 and its backward S2.

Counterpart of the chain that XLA fuses inside the JAX package's jitted
render (``tinysplat_tpu/render.py:139-169``): EWA projection
(``tinysplat_tpu/ops/projection.py:170``, ``project_gaussians``), SH colours
(``tinysplat_tpu/ops/sh.py:127``, ``eval_sh``) with the +0.5 shift and the
clamp at 0, sigmoid opacities times the Mip-Splatting compensation when
antialiased, and the RGB + depth ``colors4``.

- ``splat_fwd``: S1 (``csrc/splat_fwd.cu``) on CUDA tensors, one thread per
  splat slot; its plain version ``splat_fwd_plain`` (the port's
  ``project_gaussians`` and ``eval_sh``, op for op) on CPU tensors.
- ``splat_bwd``: S2 (``csrc/splat_bwd.cu``), the analytic backward, on CUDA
  tensors; its plain version ``splat_bwd_plain`` is the same hand-derived
  backward in column arithmetic (not autograd), with autograd's subgradient
  conventions: ``maximum`` halves the gradient at a tie, ``clamp`` passes it
  at its bounds, ``where`` passes nothing to the branch not taken.
- ``fused_splat_inputs``: both bound by a ``torch.autograd.Function``.

Both kernels are bound by the bytes they move (reckoned in ``layer_bytes``):
a few hundred FP32 operations a splat against ~0.3-0.5 KB of traffic. The
camera gradients of ``pose_opt`` (``viewmat``, ``full_projmat``,
``cam_pos``) are sums over the splats: S2 writes one float64 partial per
block and column, and a fold kernel sums each column in a fixed order, so
two launches give the same bytes. ``bwd_geometry`` gives S2's launch shape.

Every wrapper launches its kernel on CUDA tensors (counted in
``_build.launches``) or raises; CPU tensors run the plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.profiling import span
from . import _build
from .projection import COV2D_BLUR, project_gaussians
from .sh import SH_C1, SH_C2, SH_C3, SH_C4, band_of_basis, deg_from_sh, eval_sh, sh_basis

VIEWDIRS_MODES = ("reference", "position")
FLOAT_OUTPUTS = ("xys", "depths", "conics", "colors4", "opacities")
GRADS = ("means", "scales", "quats", "colors_dc", "colors_rest", "opacities")
# The camera gradient's groups: viewmat rows 0-2, full_projmat, cam_pos.
CAM_GROUPS = {"viewmat": slice(0, 12), "full_projmat": slice(12, 28), "cam_pos": slice(28, 31)}
# S1 against its plain version on the card: the float outputs to FWD_TOL x
# their column's max |plain|. The plain version's SH einsum (cuBLAS) sums in
# an order that S1's fused multiply-add chain does not reproduce: an ulp or so
# of the colours. S1 follows the other products and reductions bit for bit
# on the build it was measured on (csrc/splat_common.cuh); another build may
# order them otherwise, and everything downstream follows. A radius or tile
# count may then differ only where the plain
# value lies within BOUNDARY (relative, radius) or BOUNDARY_PX (pixels, a
# box edge) of the integer that ceil / floor rounds at; valid must match.
# S2 against its plain version (and autograd's): every gradient to BWD_TOL x
# its column's max |reference|, the camera gradient to BWD_TOL x its
# group's max.
FWD_TOL = BWD_TOL = 1e-5
BOUNDARY, BOUNDARY_PX = 1e-3, 1e-3
# The camera gradient's columns: viewmat rows 0-2 (12), full_projmat (16),
# cam_pos (3).
CAM_COLS = 31
# S2's launch (csrc/splat_bwd.cu kBwdBlock, kFoldThreads): BWD_BLOCK threads
# a block, one splat each; the camera gradient's fold runs one block of
# FOLD_THREADS threads a column.
BWD_BLOCK, FOLD_THREADS = 128, 256


class SplatLayout(NamedTuple):
    """The integer and flag settings of one projection."""

    img_width: int
    proj_height: int  # the height that projection and intrinsics use
    tile_size: int = 16
    viewdirs_mode: str = "reference"
    antialiased: bool = False


class BwdGeometry(NamedTuple):
    """S2's launch at n splats and k SH bases."""

    blocks: int  # blocks of BWD_BLOCK threads; with cam_grad, each column's partial rows
    smem_bytes: int  # dynamic shared memory a block: its colors_rest span, +16 to align
    fold_run: int  # partial rows each fold thread sums, in order


def bwd_geometry(n: int, k_bases: int) -> BwdGeometry:
    """S2's launch geometry (the kernel refuses any other): one thread a
    splat; a block stages its splats' ``colors_rest`` rows (k - 1 bases of 3
    floats) in shared memory, none at k = 1; fold thread t sums partial rows
    [t run, (t + 1) run) of each column."""
    blocks = -(-n // BWD_BLOCK)
    smem = BWD_BLOCK * (k_bases - 1) * 3 * 4 + 16 if k_bases > 1 else 0
    return BwdGeometry(blocks, smem, -(-blocks // FOLD_THREADS))


class SplatOutputs(NamedTuple):
    xys: torch.Tensor  # (N, 2)
    depths: torch.Tensor  # (N,)
    radii: torch.Tensor  # (N,) int32
    conics: torch.Tensor  # (N, 3)
    num_tiles_hit: torch.Tensor  # (N,) int32
    valid: torch.Tensor  # (N,) bool: in front, invertible and alive
    colors4: torch.Tensor  # (N, 4) RGB (+0.5, >= 0) and depth
    opacities: torch.Tensor  # (N,) sigmoid, compensated when antialiased


def antialias_compensation(conics: torch.Tensor) -> torch.Tensor:
    """Mip-Splatting opacity compensation sqrt(det Σ / det(Σ + blur·I)).

    ``conics`` (..., 3) is the inverse of the BLURRED 2D covariance; both
    determinants are recoverable from it (Σ = adj(conic)/det(conic)).
    """
    a, b, c = conics[..., 0], conics[..., 1], conics[..., 2]
    det_conic = a * c - b * b  # = 1 / det(Σ_blur); > 0 for valid splats
    safe = torch.clamp(det_conic, min=1e-12)
    det_orig = (c / safe - COV2D_BLUR) * (a / safe - COV2D_BLUR) - (b / safe) ** 2
    ratio = det_orig * safe  # det_orig / det_blur
    # The floor stays above zero so that sqrt keeps a finite gradient.
    comp = torch.sqrt(torch.clamp(ratio, 1e-8, 1.0))
    return torch.where(det_conic > 0, comp, 0.0)


def view_origin(viewmat: torch.Tensor, cam_pos: torch.Tensor, mode: str) -> torch.Tensor:
    """The point SH view directions start from. mode='reference' uses the
    view matrix's translation column (-R @ p) as the "camera position", as
    the reference framework (and its trained SH coefficients) do;
    mode='position' uses the true camera center."""
    if mode == "reference":
        return viewmat[:3, 3]
    if mode == "position":
        return cam_pos
    raise ValueError(mode)


def view_directions(means: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Per-splat unit view directions from ``origin``."""
    dirs = means - origin
    return dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)


def _check(means, scales, quats, colors_dc, colors_rest, opacities, alive, viewmat,
           full_projmat, cam_pos, layout: SplatLayout):
    n = means.shape[0]
    shapes = {"means": (means, (n, 3)), "scales": (scales, (n, 3)), "quats": (quats, (n, 4)),
              "colors_dc": (colors_dc, (n, 3)), "opacities": (opacities, (n, 1)),
              "full_projmat": (full_projmat, (4, 4)), "cam_pos": (cam_pos, (3,))}
    for name, (x, shape) in shapes.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape and not (name == "opacities" and tuple(x.shape) == (n,)):
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != means.device:
            raise ValueError(f"{name} is on {x.device}, means on {means.device}")
    if (colors_rest.dim() != 3 or colors_rest.shape[0] != n or colors_rest.shape[2] != 3
            or colors_rest.dtype != torch.float32 or colors_rest.device != means.device):
        raise ValueError(f"colors_rest must be float32 (N, K-1, 3) on {means.device}, got "
                         f"{colors_rest.dtype} {tuple(colors_rest.shape)}")
    deg_from_sh(colors_rest.shape[1] + 1)
    if tuple(viewmat.shape) not in ((4, 4), (3, 4)) or viewmat.dtype != torch.float32:
        raise ValueError(f"viewmat must be float32 (4, 4) or (3, 4), got "
                         f"{viewmat.dtype} {tuple(viewmat.shape)}")
    if alive.dtype != torch.bool or tuple(alive.shape) != (n,):
        raise ValueError(f"alive must be a bool ({n},) tensor, got {alive.dtype} "
                         f"{tuple(alive.shape)}")
    if layout.viewdirs_mode not in VIEWDIRS_MODES:
        raise ValueError(f"viewdirs_mode must be one of {VIEWDIRS_MODES}, got "
                         f"{layout.viewdirs_mode!r}")
    if layout.tile_size <= 0:
        raise ValueError(f"tile_size must be positive, got {layout.tile_size}")


def _device_kind(means: torch.Tensor, name: str) -> str:
    kind = means.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {means.device}")
    return kind


def _scalar(x, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A 0-d tensor on ``like``'s device (a no-op for one already there)."""
    return torch.as_tensor(x, dtype=dtype, device=like.device).reshape(())


def splat_fwd_plain(means, scales, quats, colors_dc, colors_rest, opacities, alive, viewmat,
                    full_projmat, cam_pos, fx, fy, cx_off, cy_off, active_degree,
                    layout: SplatLayout) -> SplatOutputs:
    """S1 in plain PyTorch: the port's ``project_gaussians`` and ``eval_sh``
    with the render path's shift, clamp, sigmoid and compensation, op for op
    (``scales`` and ``opacities`` are the stored log-scales and logits)."""
    w, ph = layout.img_width, layout.proj_height
    proj = project_gaussians(
        means=means, scales=torch.exp(scales), glob_scale=1.0, quats=quats,
        viewmat=viewmat, full_projmat=full_projmat, fx=fx, fy=fy, cx=w / 2.0 + cx_off,
        cy=ph / 2.0 + cy_off, img_height=ph, img_width=w, tile_size=layout.tile_size)
    dirs = view_directions(means, view_origin(viewmat, cam_pos, layout.viewdirs_mode))
    coeffs = torch.cat([colors_dc[:, None, :], colors_rest], dim=1)
    rgbs = eval_sh(active_degree, dirs, coeffs)
    # maximum, not clamp: at a tie (an SfM colour channel of 0 gives exactly
    # 0 here) the gradient is split in half, as in the JAX package; clamp
    # would pass all of it.
    rgbs = torch.maximum(rgbs + 0.5, rgbs.new_zeros(()))
    opac = torch.sigmoid(opacities.reshape(-1))
    if layout.antialiased:
        opac = opac * antialias_compensation(proj.conics)
    colors4 = torch.cat([rgbs, proj.depths[:, None]], dim=-1)
    return SplatOutputs(proj.xys, proj.depths, proj.radii, proj.conics, proj.num_tiles_hit,
                        proj.valid & alive, colors4, opac)


def _sh_grad(k: int, x, y, z):
    """(d/dx, d/dy, d/dz) of SH basis ``k`` >= 1 (``sh.sh_basis``) at unit
    direction components x, y, z (None: identically zero)."""
    xx, yy, zz = x * x, y * y, z * z
    return {
        1: (None, -SH_C1, None),
        2: (None, None, SH_C1),
        3: (-SH_C1, None, None),
        4: (SH_C2[0] * y, SH_C2[0] * x, None),
        5: (None, SH_C2[1] * z, SH_C2[1] * y),
        6: (-2.0 * SH_C2[2] * x, -2.0 * SH_C2[2] * y, 4.0 * SH_C2[2] * z),
        7: (SH_C2[3] * z, None, SH_C2[3] * x),
        8: (2.0 * SH_C2[4] * x, -2.0 * SH_C2[4] * y, None),
        9: (SH_C3[0] * 6.0 * x * y, SH_C3[0] * 3.0 * (xx - yy), None),
        10: (SH_C3[1] * y * z, SH_C3[1] * x * z, SH_C3[1] * x * y),
        11: (SH_C3[2] * -2.0 * x * y, SH_C3[2] * (4.0 * zz - xx - 3.0 * yy),
             SH_C3[2] * 8.0 * y * z),
        12: (SH_C3[3] * -6.0 * x * z, SH_C3[3] * -6.0 * y * z,
             SH_C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
        13: (SH_C3[4] * (4.0 * zz - 3.0 * xx - yy), SH_C3[4] * -2.0 * x * y,
             SH_C3[4] * 8.0 * x * z),
        14: (SH_C3[5] * 2.0 * x * z, SH_C3[5] * -2.0 * y * z, SH_C3[5] * (xx - yy)),
        15: (SH_C3[6] * 3.0 * (xx - yy), SH_C3[6] * -6.0 * x * y, None),
        16: (SH_C4[0] * y * (3.0 * xx - yy), SH_C4[0] * x * (xx - 3.0 * yy), None),
        17: (SH_C4[1] * 6.0 * x * y * z, SH_C4[1] * 3.0 * z * (xx - yy),
             SH_C4[1] * y * (3.0 * xx - yy)),
        18: (SH_C4[2] * y * (7.0 * zz - 1.0), SH_C4[2] * x * (7.0 * zz - 1.0),
             SH_C4[2] * 14.0 * x * y * z),
        19: (None, SH_C4[3] * z * (7.0 * zz - 3.0), SH_C4[3] * y * (21.0 * zz - 3.0)),
        20: (None, None, SH_C4[4] * z * (140.0 * zz - 60.0)),
        21: (SH_C4[5] * z * (7.0 * zz - 3.0), None, SH_C4[5] * x * (21.0 * zz - 3.0)),
        22: (SH_C4[6] * 2.0 * x * (7.0 * zz - 1.0), SH_C4[6] * -2.0 * y * (7.0 * zz - 1.0),
             SH_C4[6] * 14.0 * z * (xx - yy)),
        23: (SH_C4[7] * 3.0 * z * (xx - yy), SH_C4[7] * -6.0 * x * y * z,
             SH_C4[7] * x * (xx - 3.0 * yy)),
        24: (SH_C4[8] * 4.0 * x * (xx - 3.0 * yy), SH_C4[8] * 4.0 * y * (yy - 3.0 * xx), None),
    }[k]


def splat_bwd_plain(means, scales, quats, colors_dc, colors_rest, opacities, viewmat,
                    full_projmat, cam_pos, fx, fy, active_degree, layout: SplatLayout,
                    g_xys, g_depths, g_conics, g_colors4, g_opacities,
                    cam_grad: bool = False):
    """S2 in plain PyTorch: the analytic backward of ``splat_fwd_plain``.

    Recomputes the forward's intermediates per splat and walks the chain
    back by hand, in the kernel's order. Returns the gradients of means,
    log-scales, quats, colors_dc, colors_rest, the opacity logits (shaped
    as given) and, with ``cam_grad``, the (31,) camera gradient (viewmat
    rows 0-2, full_projmat, cam_pos), summed over the splats in float64.
    """
    f32 = torch.float32
    w_img, ph = layout.img_width, layout.proj_height
    fx = _scalar(fx, means)
    fy = _scalar(fy, means)
    V, P = viewmat, full_projmat
    W = [[V[i, j] for j in range(3)] for i in range(3)]
    origin = view_origin(viewmat, cam_pos, layout.viewdirs_mode)
    m = [means[:, i] for i in range(3)]
    half_w, half_h = 0.5 * float(w_img), 0.5 * float(ph)
    lim_x = 1.3 * ((0.5 * w_img) * torch.reciprocal(fx))
    lim_y = 1.3 * ((0.5 * ph) * torch.reciprocal(fy))

    # -- forward, recomputed ------------------------------------------------
    s = [torch.exp(scales[:, j]) for j in range(3)]
    q = [quats[:, j] for j in range(4)]
    ss = torch.sum(quats * quats, dim=-1)
    nrm = torch.sqrt(torch.clamp(ss, min=1e-24))
    qw, qx, qy, qz = (qj / nrm for qj in q)
    R = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
         [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
         [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)]]
    M = [[R[i][j] * s[j] for j in range(3)] for i in range(3)]
    Sig = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            Sig[i][j] = Sig[j][i] = (M[i][0] * M[j][0] + M[i][1] * M[j][1]) + M[i][2] * M[j][2]
    # The matmuls and reductions are the forward's own ops, so every branch
    # below (the clamps, det > 0, the ties) is taken as the forward took it.
    means_cam = means @ viewmat[:3, :3].T + viewmat[:3, 3]
    tx, ty, tz = means_cam[:, 0], means_cam[:, 1], means_cam[:, 2]
    tz_small = torch.abs(tz) < 1e-8
    tzw = torch.where(tz_small, 1e-8, tz)
    qxr, qyr = tx / tzw, ty / tzw
    cxr = torch.clamp(qxr, -lim_x, lim_x)
    cyr = torch.clamp(qyr, -lim_y, lim_y)
    txc, tyc = cxr * tzw, cyr * tzw
    rz = 1.0 / tzw
    rz2 = rz * rz
    j00, j02 = fx * rz, (-fx * txc) * rz2
    j11, j12 = fy * rz, (-fy * tyc) * rz2
    t0 = [j00 * W[0][k] + j02 * W[2][k] for k in range(3)]
    t1 = [j11 * W[1][k] + j12 * W[2][k] for k in range(3)]
    u0 = [(Sig[k][0] * t0[0] + Sig[k][1] * t0[1]) + Sig[k][2] * t0[2] for k in range(3)]
    u1 = [(Sig[k][0] * t1[0] + Sig[k][1] * t1[1]) + Sig[k][2] * t1[2] for k in range(3)]
    a = ((t0[0] * u0[0] + t0[1] * u0[1]) + t0[2] * u0[2]) + COV2D_BLUR
    b = (t0[0] * u1[0] + t0[1] * u1[1]) + t0[2] * u1[2]
    c = ((t1[0] * u1[0] + t1[1] * u1[1]) + t1[2] * u1[2]) + COV2D_BLUR
    det = a * c - b * b
    invertible = det > 0.0
    invd = 1.0 / torch.where(invertible, det, 1.0)
    hom = torch.cat([means, torch.ones_like(tz)[:, None]], dim=-1) @ P.T
    h = {j: hom[:, j] for j in (0, 1, 3)}
    h3a = torch.abs(h[3])
    rcp = 1.0 / torch.clamp(h3a, min=1e-6)
    sg = torch.sign(h[3] + 1e-30)
    rw = rcp * sg
    dirs_t = means - origin
    n = torch.linalg.norm(dirs_t, dim=-1)
    nc = torch.clamp(n, min=1e-12)
    dirs = [dirs_t[:, i] for i in range(3)]
    d = [dirs[i] / nc for i in range(3)]
    kb = colors_rest.shape[1] + 1
    coeffs = torch.cat([colors_dc[:, None, :], colors_rest], dim=1)  # (N, K, 3)
    mask = band_of_basis(kb, means.device) <= torch.as_tensor(
        active_degree, dtype=torch.int32, device=means.device)
    basis = torch.where(mask, sh_basis(torch.stack(d, dim=-1), kb), 0.0)  # (N, K)
    v = torch.einsum("...k,...kc->...c", basis, coeffs) + 0.5
    sig_o = torch.sigmoid(opacities.reshape(-1))

    # -- backward ---------------------------------------------------------------
    g_conic = [g_conics[:, k] for k in range(3)]
    g_op = g_opacities.reshape(-1)
    if layout.antialiased:
        cA, cB, cC = c * invd, -b * invd, a * invd
        det_c = cA * cC - cB * cB
        safe = torch.clamp(det_c, min=1e-12)
        qA, qB, qC = cA / safe, cB / safe, cC / safe
        x1, x2 = qC - COV2D_BLUR, qA - COV2D_BLUR
        det_o = x1 * x2 - qB * qB
        ratio = det_o * safe
        comp_s = torch.sqrt(torch.clamp(ratio, 1e-8, 1.0))
        comp = torch.where(det_c > 0, comp_s, 0.0)
        g_sig_o = g_op * comp
        g_comp = g_op * sig_o
        g_s = torch.where(det_c > 0, g_comp, 0.0)
        g_cl = g_s / (2.0 * comp_s)
        g_ratio = torch.where((ratio >= 1e-8) & (ratio <= 1.0), g_cl, 0.0)
        g_do, g_safe = g_ratio * safe, g_ratio * det_o
        g_qC, g_qA, g_qB = g_do * x2, g_do * x1, -g_do * (2.0 * qB)
        g_cC, g_cA, g_cB = g_qC / safe, g_qA / safe, g_qB / safe
        g_safe = g_safe - ((g_qC * qC + g_qA * qA) + g_qB * qB) / safe
        g_dc = torch.where(det_c >= 1e-12, g_safe, 0.0)
        g_conic = [g_conic[0] + (g_cA + g_dc * cC), g_conic[1] + (g_cB - 2.0 * g_dc * cB),
                   g_conic[2] + (g_cC + g_dc * cA)]
    else:
        g_sig_o = g_op
    g_ol = (g_sig_o * (1.0 - sig_o)) * sig_o

    # colours: maximum(v, 0) halves at a tie, passes NaN
    gc = g_colors4[:, :3]
    g_rgb = torch.where(v == 0, gc / 2, gc)
    g_rgb = torch.where(v < 0, 0.0, g_rgb)
    g_coeffs = basis[:, :, None] * g_rgb[:, None, :]  # (N, K, 3)
    g_basis = torch.where(mask, (coeffs * g_rgb[:, None, :]).sum(dim=2), 0.0)  # (N, K)
    g_d = [torch.zeros_like(n) for _ in range(3)]
    for k in range(1, kb):  # basis 0 is constant
        for i, dk in enumerate(_sh_grad(k, *d)):
            if dk is not None:
                g_d[i] = g_d[i] + g_basis[:, k] * dk
    g_nc = -(((g_d[0] * d[0] + g_d[1] * d[1]) + g_d[2] * d[2]) / nc)
    g_n = torch.where(n >= 1e-12, g_nc, 0.0)
    scale_n = torch.where(n >= 1e-12, g_n / torch.where(n >= 1e-12, n, 1.0), 0.0)
    g_dirs = [g_d[i] / nc + dirs[i] * scale_n for i in range(3)]
    g_m = list(g_dirs)

    # conics
    gA, gB, gC = g_conic
    g_a, g_b, g_c = gC * invd, -(gB * invd), gA * invd
    g_invd = (gA * c - gB * b) + gC * a
    g_det = torch.where(invertible, -g_invd * (invd * invd), 0.0)
    g_a = g_a + g_det * c
    g_c = g_c + g_det * a
    g_b = g_b - 2.0 * g_det * b

    # 2D covariance -> T rows and Sigma
    g_t0 = [2.0 * g_a * u0[k] + g_b * u1[k] for k in range(3)]
    g_t1 = [g_b * u0[k] + 2.0 * g_c * u1[k] for k in range(3)]
    D = [[2.0 * g_a * t0[i] * t0[j] + g_b * (t0[i] * t1[j] + t1[i] * t0[j])
          + 2.0 * g_c * t1[i] * t1[j] for j in range(3)] for i in range(3)]
    g_M = [[(D[i][0] * M[0][j] + D[i][1] * M[1][j]) + D[i][2] * M[2][j] for j in range(3)]
           for i in range(3)]
    g_s = [(g_M[0][j] * R[0][j] + g_M[1][j] * R[1][j]) + g_M[2][j] * R[2][j] for j in range(3)]
    g_scales = torch.stack([g_s[j] * s[j] for j in range(3)], dim=-1)
    gR = [[g_M[i][j] * s[j] for j in range(3)] for i in range(3)]
    g_qw = 2.0 * (-gR[0][1] * qz + gR[0][2] * qy + gR[1][0] * qz - gR[1][2] * qx
                  - gR[2][0] * qy + gR[2][1] * qx)
    g_qx = 2.0 * (gR[0][1] * qy + gR[0][2] * qz + gR[1][0] * qy - 2.0 * gR[1][1] * qx
                  - gR[1][2] * qw + gR[2][0] * qz + gR[2][1] * qw - 2.0 * gR[2][2] * qx)
    g_qy = 2.0 * (-2.0 * gR[0][0] * qy + gR[0][1] * qx + gR[0][2] * qw + gR[1][0] * qx
                  + gR[1][2] * qz - gR[2][0] * qw + gR[2][1] * qz - 2.0 * gR[2][2] * qy)
    g_qz = 2.0 * (-2.0 * gR[0][0] * qz - gR[0][1] * qw + gR[0][2] * qx + gR[1][0] * qw
                  - 2.0 * gR[1][1] * qz + gR[1][2] * qy + gR[2][0] * qx + gR[2][1] * qy)
    g_qn = (g_qw, g_qx, g_qy, g_qz)
    qn = (qw, qx, qy, qz)
    g_nrm = -(((g_qn[0] * qn[0] + g_qn[1] * qn[1]) + g_qn[2] * qn[2]) + g_qn[3] * qn[3]) / nrm
    g_ss = torch.where(ss >= 1e-24, g_nrm / (2.0 * nrm), 0.0)
    g_quats = torch.stack([g_qn[j] / nrm + 2.0 * q[j] * g_ss for j in range(4)], dim=-1)

    # T = J W
    g_j00 = (g_t0[0] * W[0][0] + g_t0[1] * W[0][1]) + g_t0[2] * W[0][2]
    g_j02 = (g_t0[0] * W[2][0] + g_t0[1] * W[2][1]) + g_t0[2] * W[2][2]
    g_j11 = (g_t1[0] * W[1][0] + g_t1[1] * W[1][1]) + g_t1[2] * W[1][2]
    g_j12 = (g_t1[0] * W[2][0] + g_t1[1] * W[2][1]) + g_t1[2] * W[2][2]
    g_rz = g_j00 * fx + g_j11 * fy
    g_rz2 = g_j02 * (-fx * txc) + g_j12 * (-fy * tyc)
    g_txc = g_j02 * rz2 * -fx
    g_tyc = g_j12 * rz2 * -fy
    g_rz = g_rz + 2.0 * rz * g_rz2
    g_tzw = -g_rz * (rz * rz)
    g_tzw = g_tzw + g_txc * cxr + g_tyc * cyr
    g_qxr = torch.where((qxr >= -lim_x) & (qxr <= lim_x), g_txc * tzw, 0.0)
    g_qyr = torch.where((qyr >= -lim_y) & (qyr <= lim_y), g_tyc * tzw, 0.0)
    g_tx, g_ty = g_qxr / tzw, g_qyr / tzw
    g_tzw = g_tzw - (g_qxr * qxr + g_qyr * qyr) / tzw
    g_tz = torch.where(tz_small, 0.0, g_tzw) + (g_colors4[:, 3] + g_depths)
    g_mc = (g_tx, g_ty, g_tz)
    for i in range(3):
        g_m[i] = g_m[i] + ((g_mc[0] * W[0][i] + g_mc[1] * W[1][i]) + g_mc[2] * W[2][i])

    # screen centres
    g_h = {0: g_xys[:, 0] * half_w * rw, 1: g_xys[:, 1] * half_h * rw}
    g_rw = g_xys[:, 0] * half_w * h[0] + g_xys[:, 1] * half_h * h[1]
    g_h3a = torch.where(h3a >= 1e-6, -(g_rw * sg) * (rcp * rcp), 0.0)
    g_h[3] = g_h3a * torch.sign(h[3])
    for i in range(3):
        g_m[i] = g_m[i] + ((g_h[0] * P[0, i] + g_h[1] * P[1, i]) + g_h[3] * P[3, i])

    g_means = torch.stack(g_m, dim=-1)
    g_dc = g_coeffs[:, 0, :]
    g_rest = g_coeffs[:, 1:, :]
    g_cam = None
    if cam_grad:
        zero = torch.zeros_like(n)
        cols = []
        g_T = ([g_t0[k] * j00 for k in range(3)], [g_t1[k] * j11 for k in range(3)],
               [g_t0[k] * j02 + g_t1[k] * j12 for k in range(3)])
        for i in range(3):  # viewmat row i: W[i][0..2], t[i]
            cols += [g_mc[i] * m[k] + g_T[i][k] for k in range(3)]
            cols.append(g_mc[i] - g_dirs[i] if layout.viewdirs_mode == "reference"
                        else g_mc[i])
        for j in range(4):  # full_projmat row j
            gh = g_h.get(j)
            cols += [zero] * 4 if gh is None else [gh * m[0], gh * m[1], gh * m[2], gh]
        cols += ([-g_dirs[i] for i in range(3)] if layout.viewdirs_mode == "position"
                 else [zero] * 3)
        g_cam = torch.stack(cols, dim=-1).double().sum(dim=0).to(f32)
    return (g_means, g_scales, g_quats, g_dc, g_rest, g_ol.reshape(opacities.shape), g_cam)


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C signature of each kernel's entry point; the CUDA stream comes last.
_SIGNATURES = {
    # means, scales, quats, dc, rest, opacities, alive, viewmat, projmat, cam_pos,
    # fx, fy, cx_off, cy_off, degree, n, k, width, proj_height, tile_size,
    # position, antialiased, xys, depths, radii, conics, tiles_hit,
    # valid, colors4, opacities_out, stream
    "splat_fwd": (_P,) * 15 + (_I,) * 7 + (_P,) * 9,
    # means, scales, quats, dc, rest, opacities, viewmat, projmat, cam_pos, fx, fy,
    # degree, g_xys, g_depths, g_conics, g_colors4, g_opacities, n, k, width,
    # proj_height, position, antialiased, g_means, g_scales, g_quats,
    # g_dc, g_rest, g_opacities_out, cam_grad, partials, g_cam, blocks, smem_bytes,
    # fold_run, stream
    "splat_bwd": (_P,) * 17 + (_I,) * 6 + (_P,) * 6 + (_I,) + (_P,) * 2 + (_I,) * 3 + (_P,),
}


def _launch(name: str, device: torch.device, *args) -> None:
    _build.launch(name, _SIGNATURES[name], device, *args)


def _cuda_camera(means, viewmat, full_projmat, cam_pos, fx, fy, active_degree, *extra):
    """The camera tensors as contiguous device tensors (0-d ones included;
    none is read on the host)."""
    out = [viewmat.contiguous(), full_projmat.contiguous(), cam_pos.contiguous(),
           _scalar(fx, means), _scalar(fy, means)]
    out += [_scalar(x, means) for x in extra]
    out.append(_scalar(active_degree, means, torch.int32))
    return out


def splat_fwd(means, scales, quats, colors_dc, colors_rest, opacities, alive, viewmat,
              full_projmat, cam_pos, fx, fy, cx_off, cy_off, active_degree,
              layout: SplatLayout) -> SplatOutputs:
    """The splat-input layer's forward for one camera.

    Launches S1 on CUDA tensors (``_build.launches["splat_fwd"]`` counts
    the launches) and runs ``splat_fwd_plain`` on CPU tensors.
    ``active_degree`` may be an int or a 0-d tensor; on the card it is read
    there, never on the host.
    """
    _check(means, scales, quats, colors_dc, colors_rest, opacities, alive, viewmat,
           full_projmat, cam_pos, layout)
    if _device_kind(means, "splat_fwd") == "cpu":
        return splat_fwd_plain(means, scales, quats, colors_dc, colors_rest, opacities, alive,
                               viewmat, full_projmat, cam_pos, fx, fy, cx_off, cy_off,
                               active_degree, layout)
    n, kb = means.shape[0], colors_rest.shape[1] + 1
    ins = [x.contiguous() for x in (means, scales, quats, colors_dc, colors_rest, opacities,
                                    alive)]
    cam = _cuda_camera(means, viewmat, full_projmat, cam_pos, fx, fy, active_degree, cx_off,
                       cy_off)
    view, proj, pos, fx_t, fy_t, cxo, cyo, deg = cam
    out = SplatOutputs(
        xys=means.new_empty((n, 2)), depths=means.new_empty((n,)),
        radii=torch.empty((n,), dtype=torch.int32, device=means.device),
        conics=means.new_empty((n, 3)),
        num_tiles_hit=torch.empty((n,), dtype=torch.int32, device=means.device),
        valid=torch.empty((n,), dtype=torch.bool, device=means.device),
        colors4=means.new_empty((n, 4)), opacities=means.new_empty((n,)))
    _launch("splat_fwd", means.device, *(x.data_ptr() for x in ins),
            *(x.data_ptr() for x in (view, proj, pos, fx_t, fy_t, cxo, cyo, deg)),
            n, kb, layout.img_width, layout.proj_height, layout.tile_size,
            int(layout.viewdirs_mode == "position"), int(layout.antialiased),
            *(x.data_ptr() for x in out))
    return out


def splat_bwd(means, scales, quats, colors_dc, colors_rest, opacities, viewmat, full_projmat,
              cam_pos, fx, fy, active_degree, layout: SplatLayout, g_xys, g_depths, g_conics,
              g_colors4, g_opacities, cam_grad: bool = False):
    """The splat-input layer's backward: S1's inputs and the cotangents of
    ``xys`` (N, 2), ``depths`` (N,), ``conics`` (N, 3), ``colors4`` (N, 4)
    and ``opacities`` (N,) -> the gradients ``splat_bwd_plain`` returns.

    Launches S2 on CUDA tensors (``_build.launches["splat_bwd"]`` counts
    the launches) and runs ``splat_bwd_plain`` on CPU tensors. With
    ``cam_grad`` S2 also writes one float64 partial of each camera column
    per block and folds each column in a fixed order (a second kernel of the
    same launch, one block a column).
    """
    n = means.shape[0]
    if _device_kind(means, "splat_bwd") == "cpu":
        return splat_bwd_plain(means, scales, quats, colors_dc, colors_rest, opacities,
                               viewmat, full_projmat, cam_pos, fx, fy, active_degree, layout,
                               g_xys, g_depths, g_conics, g_colors4, g_opacities, cam_grad)
    for name, g, shape in (("g_xys", g_xys, (n, 2)), ("g_depths", g_depths, (n,)),
                           ("g_conics", g_conics, (n, 3)), ("g_colors4", g_colors4, (n, 4)),
                           ("g_opacities", g_opacities, (n,))):
        if g.dtype != torch.float32 or tuple(g.shape) != shape or g.device != means.device:
            raise ValueError(f"{name} must be float32 {shape} on {means.device}, got "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")
    kb = colors_rest.shape[1] + 1
    ins = [x.contiguous() for x in (means, scales, quats, colors_dc, colors_rest, opacities)]
    view, proj, pos, fx_t, fy_t, deg = _cuda_camera(means, viewmat, full_projmat, cam_pos,
                                                    fx, fy, active_degree)
    gs = [x.contiguous() for x in (g_xys, g_depths, g_conics, g_colors4, g_opacities)]
    outs = [torch.empty_like(x) for x in ins]
    geo = bwd_geometry(n, kb)
    partials = torch.empty((CAM_COLS, geo.blocks) if cam_grad and n else (1,),
                           dtype=torch.float64, device=means.device)
    g_cam = means.new_empty((CAM_COLS,) if cam_grad else (1,))
    _launch("splat_bwd", means.device, *(x.data_ptr() for x in ins),
            *(x.data_ptr() for x in (view, proj, pos, fx_t, fy_t, deg)),
            *(x.data_ptr() for x in gs), n, kb, layout.img_width, layout.proj_height,
            int(layout.viewdirs_mode == "position"), int(layout.antialiased),
            *(x.data_ptr() for x in outs), int(cam_grad),
            partials.data_ptr(), g_cam.data_ptr(), *geo)
    return (*outs, g_cam if cam_grad else None)


def bwd_occupancy(k_bases: int, device="cuda") -> dict:
    """S2's resources on ``device``'s card at k SH bases, as the CUDA runtime
    reports them for the built kernel: registers and local (spill) bytes a
    thread, shared memory a block, and blocks resident an SM."""
    fn = _build.function("splat_bwd", "splat_bwd_info", (_I, _I, _P))
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = fn(k_bases, bwd_geometry(1, k_bases).smem_bytes, out)
    if err != 0:
        raise RuntimeError(f"splat_bwd_info failed: CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1], "smem_bytes": out[2],
            "blocks_per_sm": out[3], "threads": out[4]}


def _column_err(got: torch.Tensor, ref: torch.Tensor, scale=None):
    """(max abs difference, that over the column max |ref|, NaNs in the same
    places) over the finite entries of ``ref``; columns are the last axis."""
    a, b = got.reshape(-1, got.shape[-1]).float(), ref.reshape(-1, ref.shape[-1]).float()
    same_nan = bool(torch.equal(torch.isnan(a), torch.isnan(b)))
    finite = torch.isfinite(b)
    if a.numel() == 0 or not bool(finite.any()):
        return 0.0, 0.0, same_nan
    diff = torch.where(finite, (a - b).abs(), 0.0)
    if scale is None:
        scale = torch.where(finite, b.abs(), 0.0).amax(dim=0)
    return (float(diff.max()), float((diff / torch.clamp(scale, min=1e-30)).max()), same_nan)


def _radius_float(conics: torch.Tensor) -> torch.Tensor:
    """3 sqrt(lambda_max) of the 2D covariance, rebuilt in float64 from its
    conic, the value that ``project_gaussians`` rounds up to the radius."""
    A, B, C = (conics[:, k].double() for k in range(3))
    dc = A * C - B * B
    a, b, c = C / dc, -B / dc, A / dc
    ht = 0.5 * (a + c)
    lam = ht + torch.sqrt(torch.clamp(ht * ht - (a * c - b * b), min=0.1))
    return 3.0 * torch.sqrt(torch.clamp(lam, min=0.0))


def forward_mismatch(got: SplatOutputs, ref: SplatOutputs, tile_size: int) -> dict:
    """S1's outputs against its plain version's on the same inputs (see
    FWD_TOL): per float output (max abs, over the column max, NaNs alike,
    same bytes); the splats whose radius or tile count differ and how many
    of them lie off a rounding boundary; whether valid matches; ``ok``."""
    out = {}
    for name in FLOAT_OUTPUTS:
        a, b = getattr(got, name), getattr(ref, name)
        a2, b2 = (x.reshape(len(x), -1) for x in (a, b))
        err, scaled, same_nan = _column_err(a2, b2)
        out[name] = {"max_abs": err, "scaled": scaled, "same_nan": same_nan,
                     "bit_equal": bool(torch.equal(a2.view(torch.int32), b2.view(torch.int32)))}
    r_diff = got.radii != ref.radii
    r_f = _radius_float(ref.conics)
    r_edge = (r_f - torch.round(r_f)).abs() <= BOUNDARY * torch.clamp(r_f, min=1.0)
    t_diff = (got.num_tiles_hit != ref.num_tiles_hit) & ~r_diff
    r = ref.radii.double()[:, None]
    edges = torch.cat([ref.xys.double() - r, ref.xys.double() + r], dim=1)
    t_edge = ((edges - tile_size * torch.round(edges / tile_size)).abs()
              <= BOUNDARY_PX).any(dim=1)
    out["radii"] = {"differ": int(r_diff.sum()), "off_boundary": int((r_diff & ~r_edge).sum())}
    out["num_tiles_hit"] = {"differ": int(t_diff.sum()),
                            "off_boundary": int((t_diff & ~t_edge).sum())}
    out["valid_equal"] = bool(torch.equal(got.valid, ref.valid))
    out["ok"] = (all(out[n]["scaled"] <= FWD_TOL and out[n]["same_nan"] for n in FLOAT_OUTPUTS)
                 and out["valid_equal"] and out["radii"]["off_boundary"] == 0
                 and out["num_tiles_hit"]["off_boundary"] == 0)
    return out


def backward_mismatch(got, ref, per_column: bool = True) -> dict:
    """S2's gradients (``splat_bwd``'s tuple) against ``ref`` (its plain
    version's, or autograd's in the same order): {name: (max abs, over the
    column max, NaNs alike)}, the camera gradient by group (see BWD_TOL),
    and ``ok``. ``per_column`` False scales by each gradient's max instead:
    for a few splats, where a column's max is a value or two that cancel."""
    out = {}
    for name, a, b in zip(GRADS, got, ref):
        scale = None
        if not per_column and b.numel():
            scale = torch.where(torch.isfinite(b), b.abs(), 0.0).max()
        out[name] = _column_err(a, b, scale)
    if got[6] is not None:
        for name, sl in CAM_GROUPS.items():
            a, b = got[6][sl][None], ref[6][sl][None]
            out[name] = _column_err(a, b, torch.clamp(b.abs().max(), min=1e-30))
    out["ok"] = all(v[1] <= BWD_TOL and v[2] for v in out.values())
    return out


def layer_bytes(n: int, k_bases: int, cam_grad: bool = False):
    """(S1's bytes, S2's bytes) at n splats with k_bases SH bases: each input
    read once and each output written once (the camera's few hundred bytes
    left out). S1 reads means, log-scales, quats, K x 3 colour coefficients,
    the logit and alive (1 B) and writes xys, depth, radius, conic, tile
    count, valid (1 B), colors4 and opacity. S2 reads those inputs but alive
    and the cotangents (xys, depth, conic, colors4, opacity) and writes the
    six gradients (+ 31 float64 partials per block, written and read, with
    ``cam_grad``)."""
    ins = 4 * (3 + 3 + 4 + 3 * k_bases + 1)
    s1 = n * (ins + 1 + 4 * (2 + 1 + 1 + 3 + 1 + 4 + 1) + 1)
    s2 = n * (2 * ins + 4 * (2 + 1 + 3 + 4 + 1))
    if cam_grad:
        s2 += bwd_geometry(n, k_bases).blocks * CAM_COLS * 8 * 2
    return s1, s2


class _FusedSplatInputs(torch.autograd.Function):
    """S1 forward; backward = S2. Outputs as ``SplatOutputs``; radii, tile
    counts and valid carry no gradient."""

    @staticmethod
    def forward(ctx, means, scales, quats, colors_dc, colors_rest, opacities, viewmat,
                full_projmat, cam_pos, alive, fx, fy, cx_off, cy_off, active_degree, layout):
        out = splat_fwd(means, scales, quats, colors_dc, colors_rest, opacities, alive,
                        viewmat, full_projmat, cam_pos, fx, fy, cx_off, cy_off, active_degree,
                        layout)
        ctx.save_for_backward(means, scales, quats, colors_dc, colors_rest, opacities,
                              viewmat, full_projmat, cam_pos)
        ctx.camera = (fx, fy, active_degree, layout)
        ctx.mark_non_differentiable(out.radii, out.num_tiles_hit, out.valid)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_xys, g_depths, _radii, g_conics, _tiles, _valid, g_colors4, g_opac):
        with span("ts.splat_inputs.backward"):
            means, scales, quats, colors_dc, colors_rest, opacities, viewmat, full_projmat, \
                cam_pos = ctx.saved_tensors
            fx, fy, active_degree, layout = ctx.camera
            need = ctx.needs_input_grad
            cam_grad = any(need[6:9])
            g = splat_bwd(means, scales, quats, colors_dc, colors_rest, opacities, viewmat,
                          full_projmat, cam_pos, fx, fy, active_degree, layout, g_xys, g_depths,
                          g_conics, g_colors4, g_opac, cam_grad)
            g_view = g_proj = g_pos = None
            if cam_grad:
                g_cam = g[6]
                g_view = torch.cat([g_cam[:12].reshape(3, 4),
                                    g_cam.new_zeros((viewmat.shape[0] - 3, 4))])
                g_proj = g_cam[12:28].reshape(4, 4)
                if layout.viewdirs_mode == "position":
                    g_pos = g_cam[28:31]
            return (*g[:6], g_view, g_proj, g_pos) + (None,) * 7


def fused_splat_inputs(means, scales, quats, colors_dc, colors_rest, opacities, alive,
                       viewmat, full_projmat, cam_pos, fx, fy, cx_off, cy_off, active_degree,
                       layout: SplatLayout) -> SplatOutputs:
    """``splat_fwd`` with S2 as its backward: gradients reach means,
    log-scales, quats, both colour tensors, the opacity logits, and (when
    they require grad, as under ``pose_opt``) viewmat, full_projmat and
    cam_pos. The intrinsics are never differentiable here: raises a
    ValueError if fx, fy, cx_off or cy_off requires grad."""
    for name, x in (("fx", fx), ("fy", fy), ("cx_off", cx_off), ("cy_off", cy_off)):
        if torch.is_tensor(x) and x.requires_grad:
            raise ValueError(f"{name} requires grad: the splat-input kernels give no "
                             "gradient to the intrinsics")
    return SplatOutputs(*_FusedSplatInputs.apply(
        means, scales, quats, colors_dc, colors_rest, opacities, viewmat, full_projmat,
        cam_pos, alive, fx, fy, cx_off, cy_off, active_degree, layout))
