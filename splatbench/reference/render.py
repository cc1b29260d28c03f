"""Plain PyTorch render of a splat cloud: the yardstick the port is held to.

Semantics (3D Gaussian splatting as gsplat's legacy kernels define it, with
the tile binning of the program under test, written out here on its own):

1. Projection (EWA): Sigma = R S S^T R^T from the normalised quaternion and
   exp(log-scales); camera-space means by the view matrix; the Jacobian
   with x/z and y/z clamped to 1.3 tan(fov / 2); Sigma_2D = J W Sigma W^T
   J^T + 0.3 I; conic = Sigma_2D^-1; radius ceil(3 sqrt(lambda_max)) with
   the discriminant floored at 0.1; pixel centres through projmat @ view;
   a splat is valid when z > 0.01 and det > 0.
2. Colour: real SH up to degree 3 of the unit direction from the view
   matrix's translation column to the mean, + 0.5, floored at 0; opacity
   sigmoid(logit).
3. Tiles: a splat covers the tiles of its 3-sigma box, tightened to the
   ellipse where opacity exp(-sigma) >= 1/255, row by row of tiles; each
   tile lists its splats front to back (depth, then index).
4. Compositing, per pixel over its tile's list: sigma = 0.5 (a dx^2 + c dy^2)
   + b dx dy, alpha = min(0.999, opacity exp(-sigma)), skipped when sigma < 0
   or alpha < 1/255; front to back until the transmittance after a splat
   would fall to 1e-4 or below (that splat and all behind it are left out);
   the background weighted by the final transmittance; rgb clamped to <= 1.

Every product that a float32 program could run in TF32 goes through
``mm`` / ``einsum`` / ``conv`` here; inside ``tf32()`` (the control) their
operands are rounded to TF32's 10-bit mantissa first.

The compositing is vectorised over (tiles, entries, pixels) blocks of
tiles with similar entry counts; with gradients on, each block is
recomputed in the backward (``torch.utils.checkpoint``), so memory stays at
one block's.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4
COV2D_BLUR = 0.3
CLIP_THRESH = 0.01
BLOCK_ELEMS = 1 << 25  # (tile, entry, pixel) elements a compositing block holds

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class Precision:
    """Whether the TF32-eligible products run in TF32: set only inside
    ``tf32()``."""

    tf32 = False


@contextlib.contextmanager
def tf32():
    """The control: the TF32-eligible products in TF32 inside the block."""
    Precision.tf32 = True
    try:
        yield
    finally:
        Precision.tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest on TF32's 10-bit mantissa (float32 storage)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def _operand(x: torch.Tensor) -> torch.Tensor:
    if not Precision.tf32:
        return x
    # Rounded in the forward, passed straight through in the backward.
    return x + (round_tf32(x.detach()) - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _operand(a) @ _operand(b)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, _operand(a), _operand(b))


def conv(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    return F.conv2d(_operand(x), _operand(w), groups=groups)


class Camera(NamedTuple):
    """A camera as tensors on the render's device."""

    view: torch.Tensor  # (4, 4)
    proj: torch.Tensor  # (4, 4)
    fx: float
    fy: float
    width: int
    height: int


def camera(cam, device) -> Camera:
    """``inputs.OrbitCamera`` -> ``Camera`` on ``device``."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return Camera(t(cam.view), t(cam.proj), cam.fx, cam.fy, cam.width, cam.height)


def _sh_basis(d: torch.Tensor) -> torch.Tensor:
    """(N, 16) real SH basis to degree 3 at unit directions ``d``."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, SH_C0),
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
        SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4.0 * zz - xx - yy),
        SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), SH_C3[4] * x * (4.0 * zz - xx - yy),
        SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy),
    ], dim=-1)


def _rotmat(quats: torch.Tensor):
    """The 9 entries of the rotation of each normalised quaternion (w, x, y, z)."""
    q = quats / torch.sqrt(torch.clamp(torch.sum(quats * quats, dim=-1, keepdim=True),
                                       min=1e-24))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y))


def _cov2d(mc, s, quats, W, fx, fy, tan_x, tan_y):
    """(a, b, c) of Sigma_2D = J W Sigma W^T J^T + 0.3 I, entry by entry."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotmat(quats)
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    g00 = m00 * m00 + m01 * m01 + m02 * m02
    g01 = m00 * m10 + m01 * m11 + m02 * m12
    g02 = m00 * m20 + m01 * m21 + m02 * m22
    g11 = m10 * m10 + m11 * m11 + m12 * m12
    g12 = m10 * m20 + m11 * m21 + m12 * m22
    g22 = m20 * m20 + m21 * m21 + m22 * m22
    tx, ty, tz = mc[..., 0], mc[..., 1], mc[..., 2]
    tz = torch.where(torch.abs(tz) < 1e-8, 1e-8, tz)
    tx = torch.clamp(tx / tz, -1.3 * tan_x, 1.3 * tan_x) * tz
    ty = torch.clamp(ty / tz, -1.3 * tan_y, 1.3 * tan_y) * tz
    rz = 1.0 / tz
    rz2 = rz * rz
    j00, j02 = fx * rz, -fx * tx * rz2
    j11, j12 = fy * rz, -fy * ty * rz2
    t00 = j00 * W[0, 0] + j02 * W[2, 0]
    t01 = j00 * W[0, 1] + j02 * W[2, 1]
    t02 = j00 * W[0, 2] + j02 * W[2, 2]
    t10 = j11 * W[1, 0] + j12 * W[2, 0]
    t11 = j11 * W[1, 1] + j12 * W[2, 1]
    t12 = j11 * W[1, 2] + j12 * W[2, 2]
    u00 = g00 * t00 + g01 * t01 + g02 * t02
    u01 = g01 * t00 + g11 * t01 + g12 * t02
    u02 = g02 * t00 + g12 * t01 + g22 * t02
    u10 = g00 * t10 + g01 * t11 + g02 * t12
    u11 = g01 * t10 + g11 * t11 + g12 * t12
    u12 = g02 * t10 + g12 * t11 + g22 * t12
    a = t00 * u00 + t01 * u01 + t02 * u02 + COV2D_BLUR
    b = t00 * u10 + t01 * u11 + t02 * u12
    c = t10 * u10 + t11 * u11 + t12 * u12 + COV2D_BLUR
    return a, b, c


def project(p: Dict[str, torch.Tensor], cam: Camera) -> Dict[str, torch.Tensor]:
    """Steps 1-2: per-splat screen-space inputs of one camera (differentiable
    in ``p``): xys (N, 2), depths, radii (int32), conics (N, 3) as (a, b, c)
    of [[a, b], [b, c]], rgb (N, 3), opacity (N,), valid (N,) bool."""
    means = p["means"]
    dev = means.device
    fx = torch.as_tensor(cam.fx, dtype=torch.float32, device=dev)
    fy = torch.as_tensor(cam.fy, dtype=torch.float32, device=dev)
    W, t = cam.view[:3, :3], cam.view[:3, 3]
    mc = mm(means, W.T) + t
    depths = mc[..., 2]
    a, b, c = _cov2d(mc, torch.exp(p["scales"]), p["quats"], W, fx, fy,
                     0.5 * cam.width / fx, 0.5 * cam.height / fy)
    det = a * c - b * b
    invertible = det > 0.0
    inv_det = 1.0 / torch.where(invertible, det, 1.0)
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    half = 0.5 * (a + c)
    lam = half + torch.sqrt(torch.clamp(half * half - det, min=0.1))
    radii_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))

    full = mm(cam.proj, cam.view)
    hom = mm(torch.cat([means, torch.ones_like(depths)[..., None]], dim=-1), full.T)
    rw = 1.0 / torch.clamp(torch.abs(hom[..., 3]), min=1e-6) * torch.sign(hom[..., 3] + 1e-30)
    cx = torch.as_tensor(cam.width / 2.0, dtype=torch.float32, device=dev)
    cy = torch.as_tensor(cam.height / 2.0, dtype=torch.float32, device=dev)
    xys = torch.stack([0.5 * float(cam.width) * (hom[..., 0] * rw) + cx - 0.5,
                       0.5 * float(cam.height) * (hom[..., 1] * rw) + cy - 0.5], dim=-1)
    valid = (depths > CLIP_THRESH) & invertible
    radii = torch.where(valid, radii_f, 0.0).to(torch.int32)

    dirs = means - t
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
    coeffs = torch.cat([p["colors_dc"][:, None, :], p["colors_rest"]], dim=1)
    rgb = einsum("nk,nkc->nc", _sh_basis(dirs), coeffs)
    rgb = torch.maximum(rgb + 0.5, rgb.new_zeros(()))
    opacity = torch.sigmoid(p["opacities"].reshape(-1))
    return dict(xys=xys, depths=depths, radii=radii, conics=conics, rgb=rgb,
                opacity=opacity, valid=valid)


class Tiles(NamedTuple):
    """Each tile's splats front to back: tile t's are ``ids[starts[t]:][:counts[t]]``."""

    ids: torch.Tensor  # (E,) int64 splat ids, by tile then depth
    starts: torch.Tensor  # (tiles,) int64
    counts: torch.Tensor  # (tiles,) int64
    tiles_x: int
    tiles_y: int
    tile_h: int
    tile_w: int
    spans: int  # (splat, tile row) spans before the cut to the ellipse


@torch.no_grad()
def bin_tiles(s: Dict[str, torch.Tensor], height: int, width: int, tile_h: int,
              tile_w: int) -> Tiles:
    """Step 3 of the module docstring: the tiles each splat covers, in lists
    front to back."""
    dev = s["xys"].device
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    ts_f, ts_x = float(tile_h), float(tile_w)
    x, y = s["xys"][:, 0], s["xys"][:, 1]
    r = s["radii"].to(torch.float32)
    i32 = torch.int32
    bx0 = torch.clamp(torch.floor((x - r) / ts_x).to(i32), 0, tiles_x)
    bx1 = torch.clamp(torch.floor((x + r) / ts_x).to(i32) + 1, 0, tiles_x)
    by0 = torch.clamp(torch.floor((y - r) / ts_f).to(i32), 0, tiles_y)
    by1 = torch.clamp(torch.floor((y + r) / ts_f).to(i32) + 1, 0, tiles_y)
    empty = s["radii"] <= 0
    bx1, by1 = torch.where(empty, bx0, bx1), torch.where(empty, by0, by1)

    # The alpha >= 1/255 ellipse: sigma(dx, dy) <= t_s = log(opacity * 255).
    A = torch.clamp(s["conics"][:, 0], min=1e-12)
    B = s["conics"][:, 1]
    C = torch.clamp(s["conics"][:, 2], min=1e-12)
    t_s = torch.log(torch.clamp(s["opacity"], min=1e-30) / ALPHA_EPS)
    det = torch.clamp(A * C - B * B, min=1e-20)
    t2 = 2.0 * torch.clamp(t_s, min=0.0)
    dymax = torch.sqrt(t2 * A / det)
    dxg = torch.sqrt(t2 * C / det)
    bx0 = torch.maximum(bx0, torch.floor((x - dxg) / ts_x).to(i32))
    bx1 = torch.minimum(bx1, torch.floor((x + dxg) / ts_x).to(i32) + 1)
    by0 = torch.maximum(by0, torch.floor((y - dymax) / ts_f).to(i32))
    by1 = torch.minimum(by1, torch.floor((y + dymax) / ts_f).to(i32) + 1)
    widths = torch.clamp(bx1.long() - bx0, min=0)
    alive = s["valid"] & (t_s > 0.0) & (widths > 0)
    rows = torch.where(alive, torch.clamp(by1.long() - by0, min=0), 0)

    # One span per (splat, tile row), clipped to the ellipse's x-extent over
    # the row's pixel band [row * tile_h, row * tile_h + tile_h - 1].
    n = rows.shape[0]
    sid = torch.repeat_interleave(torch.arange(n, device=dev), rows)
    first = torch.cumsum(rows, 0) - rows
    row = by0[sid].to(torch.float32) + (torch.arange(sid.shape[0], device=dev)
                                        - first[sid]).to(torch.float32)
    p1, k1, k2, inva = -B / A, -det, t2 * A, 1.0 / A
    dystar = -B * torch.sqrt(t2 / (C * det))
    e = {k: v[sid] for k, v in dict(p1=p1, k1=k1, k2=k2, inva=inva, dystar=dystar,
                                    dymax=dymax, dxg=dxg, cx=x, cy=y).items()}

    def f_of(dy):
        return e["p1"] * dy + e["inva"] * torch.sqrt(torch.clamp(e["k1"] * dy * dy + e["k2"],
                                                                 min=0.0))

    def band_max(lo, hi):
        lo_c = torch.minimum(torch.maximum(lo, -e["dymax"]), e["dymax"])
        hi_c = torch.minimum(torch.maximum(hi, -e["dymax"]), e["dymax"])
        inside = (e["dystar"] >= lo_c) & (e["dystar"] <= hi_c)
        return torch.where(inside, e["dxg"], torch.maximum(f_of(lo_c), f_of(hi_c)))

    dy0 = row * ts_f - e["cy"]
    dy1 = dy0 + (ts_f - 1.0)
    dx_hi, dx_lo = band_max(dy0, dy1), -band_max(-dy1, -dy0)
    sbx0 = bx0[sid].to(torch.float32)
    x_last = sbx0 + torch.clamp(widths, min=1)[sid].to(torch.float32) - 1.0
    tx0 = torch.minimum(torch.maximum(torch.floor((e["cx"] + dx_lo) / ts_x), sbx0), x_last)
    tx1 = torch.minimum(torch.maximum(torch.floor((e["cx"] + dx_hi) / ts_x), tx0), x_last)
    span_len = (tx1 - tx0 + 1.0).to(torch.int64)
    span_base = (row * tiles_x + tx0).to(torch.int64)

    eid = torch.repeat_interleave(torch.arange(sid.shape[0], device=dev), span_len)
    efirst = torch.cumsum(span_len, 0) - span_len
    tile = span_base[eid] + (torch.arange(eid.shape[0], device=dev) - efirst[eid])
    ids = sid[eid]
    # Front to back inside a tile: depth, then splat index.
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.sort(torch.where(s["valid"], s["depths"], torch.inf), stable=True).indices] = \
        torch.arange(n, device=dev)
    order = torch.argsort(tile * n + rank[ids])
    ntiles = tiles_x * tiles_y
    counts = torch.bincount(tile, minlength=ntiles)
    return Tiles(ids[order], torch.cumsum(counts, 0) - counts, counts, tiles_x, tiles_y,
                 tile_h, tile_w, int(sid.shape[0]))


def _blocks(t: Tiles, pixels: int):
    """Blocks of tiles (as index tensors) of similar entry counts, each under
    ``BLOCK_ELEMS`` (tile, entry, pixel) elements."""
    counts = t.counts.cpu()
    order = torch.argsort(counts, descending=True)
    i = 0
    nz = int((counts > 0).sum())
    while i < nz:
        k = int(counts[order[i]])
        b = max(1, BLOCK_ELEMS // max(k * pixels, 1))
        yield order[i:min(i + b, nz)].to(t.counts.device), k
        i += b


def _block_geometry(t: Tiles, tiles: torch.Tensor, k: int, n: int):
    """(entry splat ids (B, k), padded with ``n``; pixel x and y (B, P))."""
    dev = tiles.device
    ar = torch.arange(k, device=dev)
    cnt = t.counts[tiles]
    slot = torch.clamp(t.starts[tiles][:, None] + ar, max=max(t.ids.shape[0] - 1, 0))
    ids = torch.where(ar < cnt[:, None], t.ids[slot], n)
    pix = torch.arange(t.tile_h * t.tile_w, device=dev)
    px = ((tiles % t.tiles_x) * t.tile_w)[:, None] + pix % t.tile_w
    py = ((tiles // t.tiles_x) * t.tile_h)[:, None] + pix // t.tile_w
    return ids, px.to(torch.float32), py.to(torch.float32)


def _alphas(ids, px, py, xy, conic, opacity):
    """(B, k, P) sigma and clamped alpha of every (entry, pixel) pair, and the
    alpha test."""
    dx = px[:, None, :] - xy[ids][..., 0:1]
    dy = py[:, None, :] - xy[ids][..., 1:2]
    cn = conic[ids]
    a, b, c = cn[..., 0:1], cn[..., 1:2], cn[..., 2:3]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp(opacity[ids][..., None] * torch.exp(-sigma), max=ALPHA_MAX)
    kept = (sigma >= 0.0) & (alpha >= ALPHA_EPS)
    return dx, dy, alpha, kept


def _composite_block(ids, px, py, xy, conic, opacity, rgb):
    """(B, P, 3) colour and (B, P) final transmittance of one block."""
    _, _, alpha, kept = _alphas(ids, px, py, xy, conic, opacity)
    a = torch.where(kept, alpha, 0.0)
    t_incl = torch.cumprod(1.0 - a, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    live = t_incl > T_EPS
    w = torch.where(live, a * t_excl, 0.0)
    colour = einsum("bkp,bkc->bpc", w, rgb[ids])
    t_final = torch.where(live, t_incl, 1.0).amin(dim=1)
    return colour, t_final


def _padded(s: Dict[str, torch.Tensor]):
    """The per-splat columns with a zero splat (opacity 0) at index N."""
    z = lambda x: torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])  # noqa: E731
    return z(s["xys"]), z(s["conics"]), z(s["opacity"]), z(s["rgb"])


def composite(s: Dict[str, torch.Tensor], t: Tiles, height: int, width: int,
              background: torch.Tensor) -> torch.Tensor:
    """Step 4: the (H, W, 3) image over ``background``, rgb clamped to <= 1.
    Differentiable in the splat columns of ``s`` when they require grad."""
    n = s["xys"].shape[0]
    dev = s["xys"].device
    cols = _padded(s)
    P = t.tile_h * t.tile_w
    ntiles = t.tiles_x * t.tiles_y
    colour = s["rgb"].new_zeros((ntiles, P, 3))
    tfin = s["rgb"].new_ones((ntiles, P))
    grad = torch.is_grad_enabled() and any(c.requires_grad for c in cols)
    parts_c, parts_t, parts_i = [], [], []
    for tiles, k in _blocks(t, P):
        ids, px, py = _block_geometry(t, tiles, k, n)
        if grad:
            c, tf = checkpoint(_composite_block, ids, px, py, *cols, use_reentrant=False)
        else:
            c, tf = _composite_block(ids, px, py, *cols)
        parts_c.append(c)
        parts_t.append(tf)
        parts_i.append(tiles)
    if parts_i:
        idx = torch.cat(parts_i)
        colour = colour.index_copy(0, idx, torch.cat(parts_c))
        tfin = tfin.index_copy(0, idx, torch.cat(parts_t))
    img = colour + tfin[..., None] * background.to(dev)
    img = img.reshape(t.tiles_y, t.tiles_x, t.tile_h, t.tile_w, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(t.tiles_y * t.tile_h, t.tiles_x * t.tile_w, 3)[:height, :width]
    return torch.minimum(img, img.new_ones(()))


def render(p: Dict[str, torch.Tensor], cam: Camera, background: torch.Tensor,
           tile_h: int, tile_w: int, budgets: Optional[dict] = None):
    """(image (H, W, 3), tiles) of the cloud ``p`` from ``cam``. ``budgets``
    (dup_capacity, max_per_tile, span_capacity), when given, are the limits
    the configuration promises its scenes stay under: raises if one is
    passed, since the program would then drop entries."""
    s = project(p, cam)
    t = bin_tiles(s, cam.height, cam.width, tile_h, tile_w)
    if budgets:
        check_budgets(t, budgets)
    return composite(s, t, cam.height, cam.width, background), t


def check_budgets(t: Tiles, budgets: dict) -> None:
    used = {"dup_capacity": int(t.ids.shape[0]), "max_per_tile": int(t.counts.max()),
            "span_capacity": t.spans}
    over = {k: (v, budgets[k]) for k, v in used.items() if k in budgets and v > budgets[k]}
    if over:
        raise ValueError(f"the scene needs more than the configuration's budgets "
                         f"(used, budget): {over}")


def entry_extent(xy_conic_opacity: torch.Tensor) -> torch.Tensor:
    """(..., 2) half-widths (ex, ey) of the box outside which no pixel passes
    the alpha test, from (..., 3) conics and (...,) opacities packed as
    (..., 4) [a, b, c, opacity]: x^2 <= 2 t_s c / det at most, with 10%
    and 1% margins on t_s and the root and half a pixel, as the compositing
    kernels cull. inf: no bound (not positive definite or too thin); -inf:
    no pixel passes."""
    a, b, c, op = xy_conic_opacity.unbind(-1)
    det = a * c - b * b
    s2 = 2.0 * (torch.clamp(torch.log(255.0 * op), min=0.0) * 1.1 + 0.1) / det
    ext = torch.stack([torch.sqrt(s2 * c) * 1.01 + 0.5, torch.sqrt(s2 * a) * 1.01 + 0.5], -1)
    bounded = (a > 0) & (c > 0) & (det > 0) & ((a + c) * (a + c) < 1e4 * det)
    ext = torch.where(bounded[..., None], ext, math.inf)
    return torch.where((op >= ALPHA_EPS)[..., None], ext, -math.inf)


@torch.no_grad()
def count_work(s: Dict[str, torch.Tensor], t: Tiles) -> Dict[str, int]:
    """What one frame's compositing needs, counted from the walk of step 4:

    - ``k1_box``: (entry, pixel) pairs a forward walk evaluates (each pixel up
      to and including the entry at which it stops) whose pixel lies in the
      entry's box (``entry_extent``): the pairs a forward must compute.
    - ``k2_box``: the same, each pixel up to its last contributing entry:
      the pairs a backward must recompute.
    - ``kept``: pairs that contribute (the backward's gradient terms).
    - ``entries``: (splat, tile) entries; ``spans``; ``valid`` splats;
      ``pixels`` of the tiles.
    """
    n = s["xys"].shape[0]
    xy, conic, opacity, _ = _padded(s)
    ext_all = entry_extent(torch.cat([conic, opacity[:, None]], -1))
    P = t.tile_h * t.tile_w
    k1 = k2 = kept = 0
    for tiles, k in _blocks(t, P):
        ids, px, py = _block_geometry(t, tiles, k, n)
        dx, dy, alpha, ok = _alphas(ids, px, py, xy, conic, opacity)
        a = torch.where(ok, alpha, 0.0)
        t_incl = torch.cumprod(1.0 - a, dim=1)
        t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
        live = t_incl > T_EPS
        walked = t_excl > T_EPS
        contrib = ok & live
        kk = torch.arange(k, device=ids.device)[None, :, None]
        last = torch.where(contrib, kk + 1, 0).amax(dim=1, keepdim=True)
        ext = ext_all[ids]
        inside = (dx.abs() <= ext[..., 0:1]) & (dy.abs() <= ext[..., 1:2])
        real = (ids < n)[..., None]
        k1 += int((inside & walked & real).sum())
        k2 += int((inside & (kk < last) & real).sum())
        kept += int((contrib & real).sum())
    return {"k1_box": k1, "k2_box": k2, "kept": kept, "entries": int(t.ids.shape[0]),
            "spans": t.spans, "valid": int(s["valid"].sum()), "splats": n,
            "tiles": t.tiles_x * t.tiles_y, "pixels": t.tiles_x * t.tiles_y * P}
