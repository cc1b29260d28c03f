"""Binning through its stages (the plain versions of B1-B4) vs the JAX
package's ``bin_splats_dense``, compared exactly (CPU).

Inputs are drawn with numpy from a seed: splats on and far off the image,
invalid ones with non-finite positions, opacities below 1/255 (culled by the
ellipse), exact depth ties. JAX's ``bin_splats_dense`` and the port bin the
same arrays, through the port's dispatcher (the whole plain version on CPU
tensors) and through ``binning_cuda.bin_splats_staged`` (B1, B2 and the
radix passes as their plain versions): every output and counter equal,
tolerance 0 (integers). The cuts are chosen from the data so that they fall
inside a splat's rows (``span_capacity``) and inside a span
(``dup_capacity``). The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_port_cuda.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.ops.binning import bin_splats_dense as jax_bin

from tinysplat_torch.ops import binning, binning_cuda
from tinysplat_torch.ops.binning import bin_splats_dense

from tests._torch_threads import one_torch_thread  # noqa: F401

W, H, N = 200, 136, 1500


def draw_splats(seed, n=N, width=W, height=H):
    """numpy splats: (xys, depths, radii, valid, conics, opacities)."""
    rng = np.random.default_rng(seed)
    xys = rng.uniform(-40, [width + 40, height + 40], size=(n, 2))
    far = rng.choice(n, n // 50, replace=False)  # far off-screen, some valid
    xys[far] = rng.choice([-1e9, 1e9, 3e7], size=(len(far), 2))
    depths = rng.uniform(0.5, 5.0, n)
    depths[rng.choice(n, n // 10, replace=False)] = 2.0  # exact ties
    radii = rng.integers(0, 48, n)
    valid = rng.uniform(size=n) > 0.1
    bad = rng.choice(np.flatnonzero(~valid), min(5, int((~valid).sum())), replace=False)
    xys[bad] = np.nan  # non-finite positions only where invalid
    L = rng.normal(size=(n, 2, 2)) * rng.uniform(0.5, 5.0, (n, 1, 1))
    cov = L @ np.swapaxes(L, 1, 2) + np.eye(2)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], axis=1)
    opac = rng.uniform(0.0, 1.0, n)
    opac[rng.choice(n, n // 10, replace=False)] = rng.uniform(0.0, 1.0 / 255.0, n // 10)
    f32 = np.float32
    return (xys.astype(f32), depths.astype(f32), radii.astype(np.int32), valid,
            conics.astype(f32), opac.astype(f32))


def _grid(tile_h, tile_x, row_stride=1):
    return -(-W // tile_x), -(-H // tile_h) // row_stride


def _static(tile_h, tile_x, row_stride=1, row_offset=0, chunk=32, **caps):
    tiles_x, tiles_y = _grid(tile_h, tile_x, row_stride)
    return dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_h, chunk=chunk,
                tile_size_x=tile_x, row_stride=row_stride, row_offset=row_offset, **caps)


@functools.lru_cache(maxsize=None)
def _jax_fn(static_items, clip):
    static = dict(static_items)

    @jax.jit
    def fn(xys, depths, radii, valid, conics, opacities):
        extra = dict(conics=conics, opacities=opacities) if clip else {}
        return jax_bin(xys, depths, radii, valid, **static, **extra)

    return fn


def bin_all(arrays, clip, **static):
    """(JAX, port dispatcher, port staged) bins of the same arrays."""
    ref = _jax_fn(tuple(sorted(static.items())), clip)(*(jnp.asarray(a) for a in arrays))
    t = [torch.tensor(a) for a in arrays]
    extra = dict(conics=t[4], opacities=t[5]) if clip else {}
    got = bin_splats_dense(*t[:4], **static, **extra)
    geom = binning.BinGeometry(static["tiles_x"], static["tiles_y"], static["tile_size"],
                               static["tile_size_x"], static["row_stride"],
                               static["row_offset"])
    caps = binning.budgets(len(arrays[0]), static["tiles_x"] * static["tiles_y"],
                           static["chunk"], static.get("dup_capacity", 0),
                           static.get("max_per_tile", 0), static.get("span_capacity", 0))
    staged = binning_cuda.bin_splats_staged(*t[:4], geom, caps, static["chunk"], **extra)
    return ref, got, staged


def assert_bins_equal(ref, got):
    for name in ("entry_rank", "order", "tile_starts", "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("num_entries", "total_intersections", "dup_overflow", "tile_overflow"):
        v = getattr(got, name)
        assert v.dtype == torch.int32 and v.dim() == 0, name
        assert int(v) == int(getattr(ref, name)), name


# Budgets that drop nothing at any of the shapes.
ROOMY = dict(max_per_tile=4096, dup_capacity=40 * N, span_capacity=20 * N)
SHAPES = {"8x8": (8, 8), "12x12": (12, 12), "16x16": (16, 16), "16x64": (16, 64),
          "32x32": (32, 32)}


@pytest.mark.parametrize("clip", [False, True], ids=["rect", "ellipse"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_stages_equal_jax(shape, clip):
    ref, got, staged = bin_all(draw_splats(1), clip, **_static(*SHAPES[shape], **ROOMY))
    assert int(got.num_entries) > 0 and int(got.dup_overflow) == 0
    assert_bins_equal(ref, got)
    assert_bins_equal(ref, staged)


@pytest.mark.parametrize("clip", [False, True], ids=["rect", "ellipse"])
@pytest.mark.parametrize("offset", [0, 2])
def test_strided_band_equals_jax(offset, clip):
    """Row stride 3: the band's local rows map back to global rows for the
    ellipse; the three bands hold every entry of the whole grid."""
    arrays = draw_splats(2)
    ref, got, staged = bin_all(arrays, clip, **_static(8, 8, 3, offset, **ROOMY))
    assert int(got.num_entries) > 0
    assert_bins_equal(ref, got)
    assert_bins_equal(ref, staged)


def test_strided_bands_partition_the_grid():
    arrays = draw_splats(2)
    # 136 px of 8-px tiles: 17 rows, 3 bands of 5 rows (rows 15, 16 unbinned)
    whole = bin_all(arrays, True, **_static(8, 8, **ROOMY))[1]
    bands = [bin_all(arrays, True, **_static(8, 8, 3, o, **ROOMY))[1]
             for o in range(3)]
    kept_rows = 15 * _grid(8, 8)[0]
    assert (sum(int(b.total_intersections) for b in bands)
            == int(whole.counts[:kept_rows].sum()))


def _spans_and_entries(arrays, static, clip):
    """Per depth rank: rows and entries (the plain B1), and their scans."""
    t = [torch.tensor(a) for a in arrays]
    geom = binning.BinGeometry(static["tiles_x"], static["tiles_y"], static["tile_size"],
                               static["tile_size_x"])
    order = binning.depth_order(t[1], t[3])
    extra = (t[4], t[5]) if clip else (None, None)
    rows, ents = binning_cuda.bin_count_plain(order, *t[0:1], t[2], t[3], geom, *extra)
    return rows.numpy().astype(np.int64), ents.numpy().astype(np.int64), geom, t, order


def test_span_capacity_cuts_inside_a_splat():
    arrays = draw_splats(3)
    static = _static(8, 8, max_per_tile=4096, dup_capacity=40 * N)
    rows, _, *_ = _spans_and_entries(arrays, static, True)
    start = np.cumsum(rows) - rows
    r = int(np.flatnonzero(rows >= 3)[len(np.flatnonzero(rows >= 3)) // 2])
    cap = int(start[r] + 1)  # keeps one of the splat's rows
    ref, got, staged = bin_all(arrays, True, **dict(static, span_capacity=cap))
    assert int(got.dup_overflow) > 0 and int(got.num_entries) > 0
    assert_bins_equal(ref, got)
    assert_bins_equal(ref, staged)


def test_dup_capacity_cuts_inside_a_span():
    arrays = draw_splats(4)
    static = _static(8, 8, chunk=8, max_per_tile=4096)
    t = [torch.tensor(a) for a in arrays]
    geom = binning.BinGeometry(static["tiles_x"], static["tiles_y"], 8, 8)
    rects = binning.splat_rects(t[0], t[2], t[3], geom, t[4], t[5])
    _, span_len, _, _ = binning.expand_spans(rects, binning.depth_order(t[1], t[3]), geom)
    lens = span_len.numpy()
    starts = np.cumsum(lens) - lens
    inside = [s + 8 - s % 8 for s, n in zip(starts, lens)
              if n >= 2 and s % 8 and s + 8 - s % 8 < s + n and s > lens.sum() // 2]
    cap = int(inside[0])  # a multiple of chunk strictly inside a span
    ref, got, staged = bin_all(arrays, True, **dict(static, dup_capacity=cap))
    assert int(got.num_entries) == cap and int(got.dup_overflow) > 0
    assert_bins_equal(ref, got)
    assert_bins_equal(ref, staged)


@pytest.mark.parametrize("clip", [False, True], ids=["rect", "ellipse"])
def test_max_per_tile_overflow(clip):
    ref, got, staged = bin_all(draw_splats(5), clip, **_static(16, 64, max_per_tile=32))
    assert int(got.tile_overflow) > 0
    assert_bins_equal(ref, got)
    assert_bins_equal(ref, staged)


def test_every_cut_at_once():
    ref, got, staged = bin_all(draw_splats(6), True, **_static(
        12, 12, chunk=8, max_per_tile=8, dup_capacity=1024, span_capacity=400))
    assert int(got.tile_overflow) > 0 and int(got.dup_overflow) > 0
    assert_bins_equal(ref, got)
    assert_bins_equal(ref, staged)


@pytest.mark.parametrize("clip", [False, True], ids=["rect", "ellipse"])
def test_staged_plain_equals_whole_plain(clip):
    """The per-stage plain functions composed give the whole plain version
    bit for bit, and B2's buffers hold the entries the whole one sorts."""
    arrays = draw_splats(7)
    static = _static(8, 8, **ROOMY)
    rows, ents, geom, t, order = _spans_and_entries(arrays, static, clip)
    extra = dict(conics=t[4], opacities=t[5]) if clip else {}
    caps = binning.budgets(N, geom.tiles_x * geom.tiles_y, 32, ROOMY["dup_capacity"],
                           ROOMY["max_per_tile"], ROOMY["span_capacity"])
    whole = binning.bin_splats_dense_plain(*t[:4], geom, caps, 32, **extra)
    staged = binning_cuda.bin_splats_staged(*t[:4], geom, caps, 32, **extra)
    for a, b in zip(whole, staged):
        assert torch.equal(a, b)
    r, e = torch.tensor(rows, dtype=torch.int32), torch.tensor(ents, dtype=torch.int32)
    keys, vals, counters = binning_cuda.bin_emit(
        order.to(torch.int32), *t[:1], t[2], t[3], geom, caps, r, e, torch.cumsum(r, 0),
        torch.cumsum(e, 0), *((t[4], t[5]) if clip else ()))
    assert counters.tolist() == [int(whole.num_entries), int(whole.total_intersections),
                                 int(whole.dup_overflow)]
    assert int(counters[1]) == int(e.sum())
    k = int(counters[0])
    perm = torch.sort(keys[:k], stable=True).indices
    assert torch.equal(vals[:k][perm], whole.entry_rank[:k])


# 12,032 and 12,033: binning_cuda.SMEM_TILES (B3's shared-memory tile
# counters on the card) and one past it.
@pytest.mark.parametrize("num_tiles", [1 << 8, 12_032, 12_033, 1 << 16, (1 << 16) + 1])
def test_radix_plain_equals_stable_sort(num_tiles):
    """The radix passes' plain versions against torch.sort(stable=True) on
    tile ids with many ties; 2^16 + 1 tiles take a third digit pass."""
    rng = np.random.default_rng(num_tiles)
    n, cap = 6000, 6400
    hot = rng.integers(0, num_tiles, 8)
    keys = np.where(rng.uniform(size=n) < 0.5, rng.choice(hot, n),
                    rng.integers(0, num_tiles, n))
    keys[:10] = num_tiles - 1
    k = torch.zeros(cap, dtype=torch.int32)
    k[:n] = torch.tensor(keys, dtype=torch.int32)
    v = torch.arange(cap, dtype=torch.int32)
    counters = torch.tensor([n, n, 0], dtype=torch.int32)
    full = torch.zeros(num_tiles, dtype=torch.int32)
    out = torch.full((cap,), -1, dtype=torch.int32)
    # ceil(log2(num_tiles + 1)) bits: 9, 14, 14, 17 and 17.
    assert binning_cuda.radix_passes(num_tiles) == (2 if num_tiles < 1 << 16 else 3)
    binning_cuda.sort_by_tile(k.clone(), v.clone(), counters, num_tiles, full, out)
    want = torch.sort(k[:n], stable=True).indices.to(torch.int32)
    assert torch.equal(out[:n], want) and (out[n:] == -1).all()
    assert torch.equal(full, torch.bincount(k[:n].long(), minlength=num_tiles).to(torch.int32))
    # One pass alone: a stable sort by that digit.
    blocks = binning_cuda.sort_blocks(cap)
    hist = binning_cuda.radix_hist(k, counters, 8, blocks)
    assert int(hist.sum()) == n
    ok, ov = torch.zeros(cap, dtype=torch.int32), torch.zeros(cap, dtype=torch.int32)
    binning_cuda.radix_scatter(k, v, hist, torch.cumsum(hist, 0, dtype=torch.int32), counters,
                               8, ok, ov)
    assert torch.equal(ov[:n], torch.sort((k[:n] >> 8) & 255, stable=True).indices.int())


def test_counters_are_device_scalars_and_other_devices_raise():
    arrays = draw_splats(8, n=300)
    t = [torch.tensor(a) for a in arrays]
    got = bin_splats_dense(*t[:4], 10, 6, conics=t[4], opacities=t[5])
    for name in ("num_entries", "total_intersections", "dup_overflow", "tile_overflow"):
        v = getattr(got, name)
        assert v.dtype == torch.int32 and v.shape == () and v.device == t[0].device, name
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bin_splats_dense(*meta[:4], 10, 6, conics=meta[4], opacities=meta[5])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        binning_cuda.radix_hist(meta[2], torch.zeros(3, dtype=torch.int32, device="meta"),
                                0, 1)


def test_empty_scene_staged():
    arrays = [a[:0] for a in draw_splats(9, n=10)]
    t = [torch.tensor(a) for a in arrays]
    geom = binning.BinGeometry(4, 2, 16, 16)
    caps = binning.budgets(0, 8, 128)
    got = binning_cuda.bin_splats_staged(*t[:4], geom, caps, 128, t[4], t[5])
    assert int(got.num_entries) == int(got.total_intersections) == 0
    assert (got.entry_rank == -1).all() and (got.counts == 0).all()
    assert (got.tile_starts == 0).all()


def test_sharded_step_sums_device_counters_on_gloo_ranks():
    """The sharded step stacks each band's counters (0-d tensors) and sums
    them over the mesh: on two gloo ranks its intersections equal the
    whole frames' of the single-device render, and nothing is dropped."""
    from tests import _torch_ranks as ranks
    from tests.test_parallel import B as NB, H as NH, W as NW, _setup
    from tests.test_torch_port_parallel import BASE, _leaves, _run_ranks

    import tinysplat_torch as tt
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.models.gaussians import from_jax_params

    state, _, gt, est = _setup()
    leaves = _leaves(state)
    cams = [c.params(device="cpu") for c in orbit_cameras(NB, width=NW, height=NH)]
    bg = np.zeros(3, np.float32)
    shards = _run_ranks(ranks.sharded_steps, 2, (1, 2), dict(BASE, tile_x=16), leaves, cams,
                        np.asarray(gt), np.asarray(est), [bg])
    m = shards[0]["metrics"]
    full = from_jax_params(leaves, "cpu")
    whole = 0
    for cam in cams:
        _, extras = tt.render(full.params, full.alive, cam, NH, NW,
                              min(2, 1), torch.tensor(bg), tile_x=16)
        whole += int(extras["binning"]["intersections"])
    assert int(m["n_intersections"]) == whole > 0
    assert int(m["n_dup_dropped"]) == int(m["n_tile_dropped"]) == 0
    for s in shards[1:]:
        assert int(s["metrics"]["n_intersections"]) == whole
