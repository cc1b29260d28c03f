"""Render pipeline: project -> SH colours -> binning -> compositing.

Torch port of ``tinysplat_tpu.render``. RGB and depth are composited
together as 4 channels in one pass; the depth channel's background is
``background[0]``, as in the JAX package. ``xys_probe`` is added to the
projected centers: its gradient is the screen-space gradient that
densification reads.

Rasterizer backends:
  'cuda'  — ops/rasterize_cuda.py: binning + the compositing kernel K1 on
            CUDA tensors, K1's plain version on CPU tensors ('auto').
  'dense' — O(N*P) oracle (tests / tiny scenes), ops/rasterize_dense.py.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .cameras import CameraParams
from .models.gaussians import GaussianParams
from .ops.projection import COV2D_BLUR, ProjectedGaussians, project_gaussians
from .ops.sh import eval_sh

RASTERIZERS = ("auto", "cuda", "dense")


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


def resolve_rasterizer(name: str) -> str:
    """'auto' (or '') -> 'cuda'; the backend then follows the tensors'
    device. Names the port's backends for any other value."""
    if name in ("auto", ""):
        return "cuda"
    if name not in RASTERIZERS:
        raise ValueError(
            f"unknown rasterizer {name!r}: the PyTorch port has {RASTERIZERS} "
            "('tiled' and 'pallas' are JAX-package backends)")
    return name


def compute_viewdirs(means: torch.Tensor, camera: CameraParams,
                     mode: str = "reference") -> torch.Tensor:
    """Per-splat unit view directions for SH evaluation.

    mode='reference' uses the view matrix's translation column (-R @ p) as
    the "camera position", as the reference framework (and its trained SH
    coefficients) do; mode='position' uses the true camera center.
    """
    if mode == "reference":
        origin = camera.viewmat[:3, 3]
    elif mode == "position":
        origin = camera.cam_pos
    else:
        raise ValueError(mode)
    dirs = means - origin
    return dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)


class SplatInputs(NamedTuple):
    """What the rasterizers consume, from one camera's projection."""

    proj: ProjectedGaussians
    xys: torch.Tensor  # (N, 2) projected centers (+ xys_probe)
    colors4: torch.Tensor  # (N, 4) RGB + camera depth
    opacities: torch.Tensor  # (N,) sigmoided (and compensated if antialiased)
    valid: torch.Tensor  # (N,) bool, projected valid & alive
    bg4: torch.Tensor  # (4,) background RGB + background[0] for depth


def splat_inputs(params: GaussianParams, alive, camera: CameraParams,
                 img_height: int, img_width: int, active_sh_degree, background,
                 xys_probe: Optional[torch.Tensor] = None,
                 viewdirs_mode: str = "reference", tile_size: int = 16,
                 antialiased: bool = False, proj_height: int = 0) -> SplatInputs:
    """EWA projection, SH colours (+0.5 shift, >= 0 clamp) and sigmoid
    opacities for one camera: the first half of :func:`render`."""
    ph = proj_height or img_height
    proj = project_gaussians(
        means=params.means,
        scales=torch.exp(params.scales),
        glob_scale=1.0,
        quats=params.quats,
        viewmat=camera.viewmat,
        full_projmat=camera.projmat @ camera.viewmat,
        fx=camera.fx,
        fy=camera.fy,
        cx=img_width / 2.0 + camera.cx_off,
        cy=ph / 2.0 + camera.cy_off,
        img_height=ph,
        img_width=img_width,
        tile_size=tile_size,
    )
    xys = proj.xys
    if xys_probe is not None:
        xys = xys + xys_probe

    viewdirs = compute_viewdirs(params.means, camera, viewdirs_mode)
    rgbs = eval_sh(active_sh_degree, viewdirs, params.sh_coeffs())
    # maximum / minimum, not clamp: at a tie (an SfM colour channel of 0
    # gives exactly 0 here) the gradient is split in half, as in the JAX
    # package; clamp would pass all of it.
    rgbs = torch.maximum(rgbs + 0.5, rgbs.new_zeros(()))

    opacities = torch.sigmoid(params.opacities.reshape(-1))
    if antialiased:
        opacities = opacities * antialias_compensation(proj.conics)
    valid = proj.valid & alive

    colors4 = torch.cat([rgbs, proj.depths[:, None]], dim=-1)
    bg4 = torch.cat([background, background[:1]], dim=-1)
    return SplatInputs(proj, xys, colors4, opacities, valid, bg4)


def render(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: CameraParams,
    img_height: int,
    img_width: int,
    active_sh_degree,
    background: torch.Tensor,
    rasterizer: str = "auto",
    xys_probe: Optional[torch.Tensor] = None,
    viewdirs_mode: str = "reference",
    tile_size: int = 16,
    dup_capacity: int = 0,
    max_per_tile: int = 0,
    span_capacity: int = 0,
    grad_reduce: str = "scatter",
    chunk: int = 128,
    tiles_per_block: int = 8,
    tile_x: int = 0,
    antialiased: bool = False,
    row_stride: int = 1,
    row_offset=0,
    proj_height: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render an (H, W, 3) image (+ extras) from Gaussian parameters.

    Everything runs on the device of ``params``: CUDA tensors go through the
    compositing kernel, CPU tensors through its plain version. Returns rgb
    (H, W, 3) clamped to <= 1 and extras with 'depth' (H, W), 'alpha'
    (H, W), 'radii' (C,), 'xys' (C, 2), 'depths' (C,), 'camera' dims and,
    for the 'cuda' backend, 'binning' diagnostics.

    Band rendering (``row_stride`` S > 1): only the interleaved global tile
    rows (``tile_size`` px) {row_offset, row_offset + S, ...} of a ``proj_height``-tall
    image, into an (img_height, W) band: the per-rank work of the sharded
    trainer's 'tile' axis. Projection and intrinsics use the full height
    (``proj_height``, default img_height). The dense oracle has no bands.
    """
    rasterizer = resolve_rasterizer(rasterizer)
    s = splat_inputs(params, alive, camera, img_height, img_width, active_sh_degree,
                     background, xys_probe=xys_probe, viewdirs_mode=viewdirs_mode,
                     tile_size=tile_size, antialiased=antialiased,
                     proj_height=proj_height)
    diag = None
    if rasterizer == "dense":
        from .ops.rasterize_dense import rasterize_dense

        if row_stride != 1:
            raise NotImplementedError("the dense oracle has no banding path (row_stride "
                                      "must be 1)")
        img4, alpha = rasterize_dense(
            s.xys, s.proj.depths, s.proj.conics, s.colors4, s.opacities, s.valid,
            img_height, img_width, s.bg4,
        )
    else:
        from .ops.rasterize_cuda import rasterize_cuda

        img4, alpha, diag = rasterize_cuda(
            s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
            s.opacities, s.valid, img_height, img_width, s.bg4,
            dup_capacity=dup_capacity, max_per_tile=max_per_tile,
            span_capacity=span_capacity, grad_reduce=grad_reduce,
            chunk=chunk, tiles_per_block=tiles_per_block, tile_x=tile_x,
            return_diagnostics=True, tile_size=tile_size,
            row_stride=row_stride, row_offset=row_offset,
        )

    rgb = torch.minimum(img4[..., :3], img4.new_ones(()))  # ties as in splat_inputs
    extras = {
        "depth": img4[..., 3],
        "alpha": alpha,
        "radii": s.proj.radii,
        "xys": s.xys,
        "depths": s.proj.depths,
        "camera": {"height": img_height, "width": img_width},
    }
    if diag is not None:
        extras["binning"] = diag
    return rgb, extras
