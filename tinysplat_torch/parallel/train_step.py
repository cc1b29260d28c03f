"""Sharded training step: FSDP splat sharding + pixel-band rasterization.

Torch port of ``tinysplat_tpu.parallel.train_step``. Every rank of the
('data', 'tile') mesh (``sharding.py``) runs the step on its shard, and the
ranks meet only in the collectives of ``collectives.py``:

  1. all_gather(params, 'data') — the FSDP gather: each tile column holds a
     1/n_tile slice of the splats. Its transpose, a reduce-scatter of the
     parameter gradients over 'data', is the data-parallel reduction.
  2. EWA projection + SH colours of the column's splats, per local camera
     (each data group renders B / n_data cameras; the loss is the batch
     mean, so B = 1 is the one-camera step).
  3. all_gather(projected attributes, 'tile') — every rank needs every
     splat that may hit its pixel band; ~10 floats a splat instead of the
     parameters. Transpose: a reduce-scatter of the screen-space gradients.
  4. Binning + compositing (K1 forward, K2 and the ``grad_reduce`` reduction
     backward) of the rank's band of tile rows (``cfg.tile_size`` px) only:
     interleaved (global tile rows {t, t + n_tile, ...},
     ``cfg.band_interleave``; needs tile_size >= SSIM_HALO) or a contiguous
     strip.
  5. L1 + DSSIM (+ the scheduled depth, opacity, MCMC and density terms).
     SSIM is exact under row sharding: each band extends its rows by a
     10-row halo from the band below (ppermute) and masks windows that cross
     the image bottom; the partial sums over the mesh add up to the
     one-device value.
  6. Adam on the rank's 1/(n_data n_tile) shard (the optimizer state is
     sharded the same way), the MCMC noise on the shard's rows of the one
     full-capacity draw, and the densify accumulator of the shard's rows.

Conventions: every psum'd value is replicated and the collectives have
exact transposes, so each rank back-propagates a unit cotangent of the one
loss (``collectives`` module docstring). Binning diagnostics are summed
over the mesh, so a band that overflows its budget shows in
``n_dup_dropped`` / ``n_tile_dropped``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..cameras import CameraParams, apply_pose_delta
from ..config import Config
from ..models.gaussians import GaussianParams, GaussianState
from ..ops.rasterize_cuda import rasterize_cuda
from ..ops.ssim import ssim_maps
from ..render import resolve_rasterizer, splat_inputs
from ..train import _resolve_background, _schedule_gate, apply_appearance, means_lr_at
from . import collectives as col
from .sharding import Mesh

SSIM_HALO = 10  # win_size - 1


class ShardedStepOutput(NamedTuple):
    state: GaussianState
    opt_state: Any
    metrics: Dict[str, Any]


def band_rows(H: int, n_bands: int, band: int, tile_size: int, interleave: bool,
              device=None) -> torch.Tensor:
    """The global pixel rows of ``band`` of ``n_bands``, in band order:
    tile-row groups {band, band + n_bands, ...} when interleaved, else the
    contiguous strip [band H / n, (band + 1) H / n)."""
    hl = H // n_bands
    if not interleave:
        return torch.arange(band * hl, (band + 1) * hl, device=device)
    groups = torch.arange(hl // tile_size, device=device) * n_bands + band
    return (groups[:, None] * tile_size + torch.arange(tile_size, device=device)).reshape(-1)


def band_major_rows(H: int, n_bands: int, tile_size: int, interleave: bool,
                    device=None) -> torch.Tensor:
    """Every band's rows, band after band: an image's rows taken in this
    order put band t in the t-th block of H / n_bands rows."""
    return torch.cat([band_rows(H, n_bands, t, tile_size, interleave, device)
                      for t in range(n_bands)])


def deinterleave(bands: torch.Tensor, H: int, n_bands: int, tile_size: int,
                 interleave: bool) -> torch.Tensor:
    """(B, n_bands * Hl, ...) bands in band-major order -> (B, H, ...) rows
    in global order."""
    return bands[:, torch.argsort(band_major_rows(H, n_bands, tile_size, interleave,
                                                  bands.device))]


def pack_params(params: GaussianParams) -> torch.Tensor:
    """(C, 59 at SH degree 3) the six fields side by side, one gather."""
    c = params.capacity
    return torch.cat([t.reshape(c, -1) for _, t in params.fields()], dim=1)


def unpack_params(packed: torch.Tensor, like: GaussianParams) -> GaussianParams:
    out, k = {}, 0
    for name, t in like.fields():
        w = math.prod(t.shape[1:])
        out[name] = packed[:, k:k + w].reshape((packed.shape[0],) + tuple(t.shape[1:]))
        k += w
    return GaussianParams(**out)


def _ssim_partial(x, y, H: int, W: int, mesh: Mesh, t_idx: int, interleave: bool,
                  tile_size: int) -> torch.Tensor:
    """This band's share of the sum of the global valid-mode SSIM map, over
    (Bl, Hl, W, 3) bands; the mesh-wide sum over every band is the
    one-device sum (window start positions partition the map)."""
    Bl, Hl = x.shape[0], x.shape[1]
    nt, tile = mesh.tile, mesh.groups["tile"]
    if not interleave:
        halo = min(SSIM_HALO, Hl)
        pairs = [(t, t - 1) for t in range(1, nt)]
        hx = col.ppermute(x[:, :halo], tile, pairs, "ssim_halo")
        hy = col.ppermute(y[:, :halo], tile, pairs, "ssim_halo")
        smap = ssim_maps(torch.cat([x, hx], 1), torch.cat([y, hy], 1))
        rows = t_idx * Hl + torch.arange(smap.shape[1], device=x.device)
        mask = (rows < H - SSIM_HALO).to(x.dtype)
        return (smap * mask[None, :, None, None]).sum()
    # Band t holds global tile rows {t, t + nt, ...} in G groups. A group's
    # windows that cross its bottom need the next SSIM_HALO global rows: the
    # head of the same group on band t + 1, or from the last band, of group
    # g + 1 on band 0 (a ring ppermute, then a roll by one group on the last
    # band; its wrapped-in group is masked: rows past H - halo). Every rank
    # rolls (by 0 but on the last band), so all build the same graph.
    G = Hl // tile_size
    xg = x.reshape(Bl, G, tile_size, W, 3)
    yg = y.reshape(Bl, G, tile_size, W, 3)
    ring = [(t, (t - 1) % nt) for t in range(nt)]
    shift = -1 if t_idx == nt - 1 else 0
    hx = torch.roll(col.ppermute(xg[:, :, :SSIM_HALO], tile, ring, "ssim_halo"), shift, 1)
    hy = torch.roll(col.ppermute(yg[:, :, :SSIM_HALO], tile, ring, "ssim_halo"), shift, 1)
    xe = torch.cat([xg, hx], 2).reshape(Bl * G, tile_size + SSIM_HALO, W, 3)
    ye = torch.cat([yg, hy], 2).reshape(Bl * G, tile_size + SSIM_HALO, W, 3)
    smap = ssim_maps(xe, ye).reshape(Bl, G, tile_size, W - SSIM_HALO, 3)
    g_idx = torch.arange(G, device=x.device)[:, None]
    r_idx = torch.arange(tile_size, device=x.device)[None, :]
    rows = (t_idx + g_idx * nt) * tile_size + r_idx
    mask = (rows < H - SSIM_HALO).to(x.dtype)
    return (smap * mask[None, :, :, None, None]).sum()


def dist_ssim(x, y, H: int, W: int, B: int, mesh: Mesh, interleave: bool,
              tile_size: int) -> torch.Tensor:
    """Exact global mean SSIM of (B, H, W, 3) batches held as this rank's
    (B / n_data, Hl, W, 3) bands (interleaved or contiguous rows)."""
    s = _ssim_partial(x, y, H, W, mesh, mesh.coords[1], interleave, tile_size)
    return col.psum(s, mesh.groups["world"]) / (B * (H - SSIM_HALO) * (W - SSIM_HALO) * 3)


def _check_mesh_shape(cfg: Config, H: int, B: int, mesh: Mesh):
    n_data, n_tile = mesh.data, mesh.tile
    assert H % n_tile == 0, f"image height {H} not divisible by tile axis {n_tile}"
    assert B % n_data == 0, f"batch {B} not divisible by data axis {n_data}"
    Hl = H // n_tile
    assert Hl >= SSIM_HALO, f"band height {Hl} < SSIM halo {SSIM_HALO}"
    # Bands of whole tile rows cull exactly the splat / tile pairs of one
    # device (mid-tile boundaries would change the binning).
    assert Hl % cfg.tile_size == 0, (
        f"band height {Hl} not a multiple of tile_size {cfg.tile_size}; "
        f"pad the image so H is divisible by n_tile * tile_size")
    interleave = bool(cfg.band_interleave) and n_tile > 1
    if interleave and cfg.tile_size < SSIM_HALO:
        # The grouped halo ships SSIM_HALO rows a group from the next group:
        # a group shorter than that would drop window rows from the loss.
        raise ValueError(
            f"interleaved bands need tile_size >= the SSIM halo of {SSIM_HALO} rows (got "
            f"{cfg.tile_size}); disable --band-interleave or use larger tiles")
    return Hl, interleave


def _band_kwargs(cfg: Config) -> dict:
    return dict(dup_capacity=cfg.dup_capacity, max_per_tile=cfg.max_per_tile,
                span_capacity=cfg.span_capacity, grad_reduce=cfg.grad_reduce,
                tile_x=cfg.tile_x, tile_size=cfg.tile_size, return_diagnostics=True)


def _gather_attrs(s, group, order=None):
    """The projected attributes of one camera, gathered over ``group``
    and put in global capacity order by ``order`` (None: already in it):
    (floats (C, 10) differentiable, radii (C,), valid (C,)); a float row is
    [x, y, conic a, b, c, r, g, b, depth, opacity]."""
    floats = torch.cat([s.xys, s.proj.conics, s.colors4, s.opacities[:, None]], dim=1)
    ints = torch.stack([s.proj.radii.to(torch.int32), s.valid.to(torch.int32)], dim=1)
    floats = col.all_gather(floats, group, "attr_gather")
    ints = col.all_gather_raw(ints, group, "attr_gather")
    if order is not None:
        floats, ints = floats[order], ints[order]
    return floats, ints[:, 0], ints[:, 1].bool()


def global_order(mesh: Mesh, c_shard: int, device) -> Optional[torch.Tensor]:
    """Where each global capacity row sits after the gathers over 'data'
    then 'tile' (tile column t holds blocks t, n_tile + t, ...), or None
    when that is already the global order (one axis of size 1). Binning
    breaks exact depth ties (a densify clone and its source) by position,
    so the bands see the rows in the one-device order and a step does not
    depend on the mesh's shape."""
    if mesh.data == 1 or mesh.tile == 1:
        return None
    g = torch.arange(c_shard * mesh.size, device=device)
    block, i = g // c_shard, g % c_shard
    return ((block % mesh.tile) * mesh.data + block // mesh.tile) * c_shard + i


def make_sharded_train_step(cfg: Config, img_height: int, img_width: int, batch: int,
                            mesh: Mesh, use_depth: bool = False, use_density: bool = False):
    """Build this rank's step of the multi-device train step.

    Args:
      batch: global cameras per step (divisible by the mesh's 'data' size).
      use_depth: an estimated-depth band is given per step (the depth
        regularizer).
      use_density: a ``DensityProbe`` is given per step, holding this tile
        rank's block of the sample points (the full parameter set the KNN
        reads is one flat gather over the mesh; each camera's depth map is
        re-assembled from the bands).

    Returns ``train_step(state, opt_state, cams, gt, est_depth, step,
    generator=None, background=None, density_probe=None, pose_deltas=None,
    app_params=None, noise_eps=None)`` -> ``ShardedStepOutput``, where
    ``state`` / ``opt_state`` are this rank's shard (``shard_state``), which
    the step updates in place; ``cams`` the data group's B / n_data
    ``CameraParams``; ``gt`` (B / n_data, Hl, W, 3) and ``est_depth``
    (B / n_data, Hl, W) this rank's band (``band_rows``); ``pose_deltas`` /
    ``app_params`` (B / n_data, 6 / 12) the local cameras'. ``background``
    overrides the cfg's; ``generator`` (identical on every rank) draws the
    random background and the MCMC noise unless ``noise_eps`` (C, 3) gives
    the full-capacity draw. The metrics are the mesh's: replicated scalars,
    and with pose_opt / app_opt the (B, 6) / (B, 12) gradients.
    """
    n_data, n_tile = mesh.data, mesh.tile
    H, W, B = img_height, img_width, batch
    Hl, interleave = _check_mesh_shape(cfg, H, B, mesh)
    resolve_rasterizer(cfg.rasterizer)  # a band always goes through rasterize_cuda
    Bl = B // n_data
    d_idx, t_idx = mesh.coords
    world, data_g, tile_g = mesh.groups["world"], mesh.groups["data"], mesh.groups["tile"]
    band_kw = _band_kwargs(cfg)
    if interleave:
        stride, offset, y0 = n_tile, t_idx, 0.0
    else:
        stride, offset, y0 = 1, 0, float(t_idx * Hl)

    def train_step(state: GaussianState, opt_state, cams: List[CameraParams],
                   gt: torch.Tensor, est_depth: Optional[torch.Tensor], step: int,
                   generator: Optional[torch.Generator] = None,
                   background: Optional[torch.Tensor] = None, density_probe=None,
                   pose_deltas: Optional[torch.Tensor] = None,
                   app_params: Optional[torch.Tensor] = None,
                   noise_eps: Optional[torch.Tensor] = None) -> ShardedStepOutput:
        step = int(step)
        assert len(cams) == Bl and tuple(gt.shape[:3]) == (Bl, Hl, W), (
            f"expected {Bl} cameras and a ({Bl}, {Hl}, {W}, 3) band, got {len(cams)} and "
            f"{tuple(gt.shape)}")
        dev = gt.device
        c_shard = state.capacity
        active_deg = min(cfg.sh_degree, 1 + step // cfg.sh_increment_interval)
        if background is None:
            background = _resolve_background(cfg, generator, dev)
        bg4 = torch.cat([background, background[:1]])
        alive_col = col.all_gather_raw(state.alive, data_g, "param_gather")
        n_live = col.all_reduce_raw(state.alive.sum(), world)
        c_col = alive_col.shape[0]
        probes = [torch.zeros((c_col, 2), dtype=torch.float32, device=dev,
                              requires_grad=True) for _ in range(Bl)]
        pose = (pose_deltas.detach().clone().requires_grad_()
                if cfg.pose_opt and pose_deltas is not None else None)
        app = (app_params.detach().clone().requires_grad_()
               if cfg.app_opt and app_params is not None else None)
        opt_state.zero_grad(set_to_none=True)

        # (0) pose_opt: refine the local cameras by their SE(3) deltas.
        vcams = [apply_pose_delta(c, pose[b]) if pose is not None else c
                 for b, c in enumerate(cams)]
        # (1) FSDP gather over 'data' -> this tile column's splats.
        params_col = unpack_params(col.all_gather(pack_params(state.params), data_g,
                                                  "param_gather"), state.params)
        order = global_order(mesh, c_shard, dev)
        rgbs, depths, diag = [], [], torch.zeros(3, dtype=torch.int64, device=dev)
        for b, cam in enumerate(vcams):
            # (2) project + SH, (3) gather over 'tile', (4) this band.
            s = splat_inputs(params_col, alive_col, cam, H, W, active_deg, background,
                             xys_probe=probes[b], viewdirs_mode=cfg.viewdirs_mode,
                             tile_size=cfg.tile_size, antialiased=cfg.antialiased)
            f, radii, valid = _gather_attrs(s, tile_g, order)
            xys = f[:, 0:2] - f.new_tensor([0.0, y0])
            img4, _, dg = rasterize_cuda(xys, f[:, 8], radii, f[:, 2:5], f[:, 5:9], f[:, 9],
                                         valid, Hl, W, bg4, row_stride=stride,
                                         row_offset=offset, **band_kw)
            rgb = torch.minimum(img4[..., :3], img4.new_ones(()))
            if app is not None:  # app_opt: per-camera affine exposure
                rgb = apply_appearance(rgb, app[b])
            rgbs.append(rgb)
            depths.append(img4[..., 3])
            # 0-d device tensors: stacked where they lie, never read on the host.
            diag += torch.stack([dg["intersections"], dg["dup_dropped"], dg["tile_dropped"]])
        rgb, depth = torch.stack(rgbs), torch.stack(depths)

        # (5) losses: every psum spans the mesh; the partial sums go in one.
        npix = B * H * W
        parts = {"l1": torch.abs(rgb - gt).sum(),
                 "ssim": _ssim_partial(rgb, gt, H, W, mesh, t_idx, interleave, cfg.tile_size)}
        depth_on = cfg.regularize_depth and use_depth
        if depth_on:
            parts["depth"] = torch.abs(depth - est_depth).sum()
        if cfg.densify_strategy == "mcmc":
            if cfg.lambda_mcmc_opacity > 0:
                o = torch.sigmoid(state.params.opacities.reshape(-1))
                parts["mcmc_opacity"] = torch.where(state.alive, o, 0.0).sum()
            if cfg.lambda_mcmc_scale > 0:
                sc = torch.exp(state.params.scales)
                parts["mcmc_scale"] = torch.where(state.alive[:, None], sc, 0.0).sum()
        if cfg.regularize_opacity:
            o = torch.sigmoid(state.params.opacities.reshape(-1))
            ent = -(o * torch.log(o + 1e-10) + (1 - o) * torch.log(1 - o + 1e-10))
            parts["opacity"] = torch.where(state.alive, ent, 0.0).sum()
        names = list(parts)
        sums = dict(zip(names, col.psum(torch.stack([parts[k] for k in names]), world)))
        n_live_f = torch.clamp(n_live, min=1).to(torch.float32)

        loss_l1 = sums["l1"] / (npix * 3)
        loss_ssim = 1.0 - sums["ssim"] / (B * (H - SSIM_HALO) * (W - SSIM_HALO) * 3)
        loss = (1.0 - cfg.lambda_dssim) * loss_l1 + cfg.lambda_dssim * loss_ssim
        aux = {"loss_l1": loss_l1, "loss_ssim": loss_ssim}
        if depth_on:
            gate = _schedule_gate(True, cfg.regularize_depth_start, cfg.regularize_depth_end,
                                  step)
            aux["loss_depth"] = sums["depth"] / npix
            loss = loss + gate * cfg.lambda_depth * aux["loss_depth"]
        if "mcmc_opacity" in sums:
            aux["loss_mcmc_opacity"] = sums["mcmc_opacity"] / n_live_f
            loss = loss + cfg.lambda_mcmc_opacity * aux["loss_mcmc_opacity"]
        if "mcmc_scale" in sums:
            aux["loss_mcmc_scale"] = sums["mcmc_scale"] / (3 * n_live_f)
            loss = loss + cfg.lambda_mcmc_scale * aux["loss_mcmc_scale"]
        if cfg.regularize_opacity:
            gate = _schedule_gate(True, cfg.regularize_opacity_start,
                                  cfg.regularize_opacity_end, step)
            aux["loss_opacity"] = sums["opacity"] / n_live_f
            loss = loss + gate * cfg.lambda_opacity * aux["loss_opacity"]
        if use_density and cfg.regularize_density and density_probe is not None:
            aux["loss_density"] = _density_term(cfg, density_probe, state, depth, vcams, H, W,
                                                B, mesh, interleave)
            gate = _schedule_gate(True, cfg.regularize_density_start,
                                  cfg.regularize_density_end, step)
            loss = loss + gate * cfg.lambda_density * aux["loss_density"]
        loss.backward()

        # (6) sharded Adam, MCMC noise, densify accumulator.
        opt_state.step()
        if cfg.densify_strategy == "mcmc":
            from ..models.densify_mcmc import apply_noise

            # The one full-capacity draw of the one-device step (identical
            # generators on every rank), this rank's rows of it: rank
            # (d, t) holds global block d * n_tile + t.
            eps = noise_eps
            if eps is None:
                eps = torch.randn((c_shard * mesh.size, 3), generator=generator, device=dev)
            row0 = mesh.rank * c_shard
            apply_noise(state.params, state.alive, eps[row0:row0 + c_shard],
                        cfg.mcmc_noise_lr * means_lr_at(cfg, step), cfg)
        with torch.no_grad():
            gnorm = torch.stack([torch.linalg.norm(p.grad, dim=-1) for p in probes]).sum(0)
            gnorm = col.all_reduce_raw(gnorm, data_g)[d_idx * c_shard:(d_idx + 1) * c_shard]
            accum = state.means_grad_accum
            if step >= cfg.warmup_grad:
                accum = accum + gnorm
            mse_diag = col.all_reduce_raw(
                torch.cat([((rgb.detach() - gt) ** 2).sum().reshape(1).double(),
                           diag.to(dev).double()]), world)
        new_state = dataclasses.replace(
            state, means_grad_accum=accum,
            active_sh_degree=torch.tensor(active_deg, dtype=torch.int32, device=dev))
        mse = mse_diag[0].float() / (npix * 3)
        metrics = {
            "loss": loss.detach(),
            "psnr": 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)),
            "num_live": n_live,
        }
        for k in ("loss_l1", "loss_ssim", "loss_depth", "loss_opacity", "loss_density"):
            if k in aux:
                metrics[k] = aux[k].detach()
        for i, k in enumerate(("n_intersections", "n_dup_dropped", "n_tile_dropped")):
            metrics[k] = int(mse_diag[1 + i])
        for name, leaf in (("pose_grad", pose), ("app_grad", app)):
            if leaf is not None:  # (B, k): psum over 'tile', gathered over 'data'
                g = col.all_reduce_raw(leaf.grad, tile_g)
                metrics[name] = col.all_gather_raw(g, data_g, "gather")
        return ShardedStepOutput(new_state, opt_state, metrics)

    return train_step


def _density_term(cfg: Config, probe, state: GaussianState, depth: torch.Tensor, vcams,
                  H: int, W: int, B: int, mesh: Mesh, interleave: bool) -> torch.Tensor:
    """The SuGaR density term of the mesh: the full parameters from one
    flat gather (rank order is the global capacity order, so the probe's
    KNN indices hold), this tile rank's block of the probe points, each
    local camera's depth map re-assembled from the bands."""
    from ..regularizers.density import approximate_density, density_at_points, probe_beta

    world, data_g, tile_g = mesh.groups["world"], mesh.groups["data"], mesh.groups["tile"]
    params_full = unpack_params(col.all_gather(pack_params(state.params), world,
                                               "param_gather"), state.params)
    # (Bl, Hl, W) bands -> (Bl, H, W): gather the rows over 'tile' (dim 0).
    bands = col.all_gather(depth.transpose(0, 1).contiguous(), tile_g, "attr_gather")
    depth_full = deinterleave(bands.transpose(0, 1), H, mesh.tile, cfg.tile_size, interleave)
    d = density_at_points(probe.points, probe.knn_idx, params_full)
    beta = probe_beta(params_full, probe.knn_idx)  # live scales
    errs, counts = [], []
    for b, cam in enumerate(vcams):
        est, mask = approximate_density(probe.points, depth_full[b], cam, beta, H, W,
                                        return_sdf=cfg.regularize_sdf)
        if cfg.regularize_sdf:
            sdf = beta * torch.sqrt(-2.0 * torch.log(torch.clamp(d, 0.001, 0.999)))
            err = torch.abs(sdf - est)
        else:
            err = torch.abs(d - est)
        errs.append(torch.where(mask, err, 0.0).sum())
        counts.append(mask.to(err.dtype).sum())
    e = col.psum(torch.stack(errs), tile_g)
    c = col.all_reduce_raw(torch.stack(counts), tile_g)
    per_cam = e / torch.clamp(c, min=1.0)
    return col.psum(per_cam.sum(), data_g) / B


def make_sharded_render(cfg: Config, img_height: int, img_width: int, mesh: Mesh):
    """Sharded inference render: one camera, pixel rows over every rank of
    the mesh, splats FSDP-sharded (each rank projects its own shard).

    Returns ``render_fn(params, alive, active_deg, cam, background)`` ->
    (rgb (H, W, 3), depth (H, W), alpha (H, W)), the whole image on every
    rank (the bands gathered and, when interleaved, put back in order)."""
    n = mesh.size
    H, W = img_height, img_width
    assert H % n == 0, f"image height {H} not divisible by the {n} ranks"
    Hl = H // n
    ts = cfg.tile_size
    # Interleave tile rows over every rank when the shape allows it.
    interleave = bool(cfg.band_interleave) and n > 1 and Hl % ts == 0
    idx, world = mesh.rank, mesh.groups["world"]
    band_kw = _band_kwargs(cfg)
    band_kw["grad_reduce"] = "scatter"  # no backward
    if interleave:
        stride, offset, y0 = n, idx, 0.0
    else:
        stride, offset, y0 = 1, 0, float(idx * Hl)

    @torch.no_grad()
    def render_fn(params: GaussianParams, alive, active_deg, cam: CameraParams, background):
        s = splat_inputs(params, alive, cam, H, W, active_deg, background,
                         viewdirs_mode=cfg.viewdirs_mode, tile_size=ts,
                         antialiased=cfg.antialiased)
        f, radii, valid = _gather_attrs(s, world)
        xys = f[:, 0:2] - f.new_tensor([0.0, y0])
        img4, alpha, _ = rasterize_cuda(xys, f[:, 8], radii, f[:, 2:5], f[:, 5:9], f[:, 9],
                                        valid, Hl, W, s.bg4, row_stride=stride,
                                        row_offset=offset, **band_kw)
        band = torch.cat([torch.minimum(img4[..., :3], img4.new_ones(())), img4[..., 3:4],
                          alpha[..., None]], dim=-1)  # (Hl, W, 5)
        full = deinterleave(col.all_gather_raw(band, world, "gather")[None], H, n, ts,
                            interleave)[0]
        return full[..., :3], full[..., 3], full[..., 4]

    return render_fn

