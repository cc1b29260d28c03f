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
from .ops.projection import ProjectedGaussians
from .ops.splat_inputs_cuda import SplatLayout, fused_splat_inputs
from .utils.profiling import span

RASTERIZERS = ("auto", "cuda", "dense")


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
    opacities for one camera: the first half of :func:`render`.

    One pass of the splat-input kernel S1 on CUDA tensors (its plain version
    on CPU tensors), with S2 as its backward
    (``ops.splat_inputs_cuda.fused_splat_inputs``). ``proj.valid`` here is
    ``valid``: in front, invertible and alive.
    """
    layout = SplatLayout(img_width, proj_height or img_height, tile_size, viewdirs_mode,
                         antialiased)
    out = fused_splat_inputs(
        params.means, params.scales, params.quats, params.colors_dc, params.colors_rest,
        params.opacities, alive, camera.viewmat, camera.full_projmat,
        camera.cam_pos, camera.fx, camera.fy, camera.cx_off, camera.cy_off,
        active_sh_degree, layout)
    proj = ProjectedGaussians(out.xys, out.depths, out.radii, out.conics, out.num_tiles_hit,
                              out.valid)
    xys = out.xys if xys_probe is None else out.xys + xys_probe
    bg4 = torch.cat([background, background[:1]], dim=-1)
    return SplatInputs(proj, xys, out.colors4, out.opacities, out.valid, bg4)


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
    with span("ts.render.splat_inputs"):
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

    with span("ts.render.untile"):
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
