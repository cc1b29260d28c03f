"""Port compositing (K1's plain version, via ``rasterize_cuda`` on CPU
tensors) vs the JAX package's dense oracle and Pallas kernel.

Tolerances: images and alpha to 2e-4 against the dense oracle (the
reference suite's, test_torch_oracle.py); raw [c0..c3, T_final] rows to
1e-5 against the Pallas kernel in interpret mode (its log-space cumulative
product differs from a direct product by ~1e-6), and n_contrib /
last_contrib exactly. The CUDA kernel itself is held against the plain
version on the card (``chip_smoke.py``; the ``cuda``-marked test here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.ops import rasterize_pallas as rp
from tinysplat_tpu.ops.binning import bin_splats_dense as jax_bin

from tinysplat_torch.ops import _build
from tinysplat_torch.ops import rasterize_cuda as rc

from test_rasterize_tiled import dense_reference, random_case

from tests._torch_threads import one_torch_thread  # noqa: F401


def _torch_args(case):
    xys, depths, radii, conics, colors, opac, valid, H, W, bg = case
    t = torch.tensor
    return (t(xys), t(depths), t(radii), t(conics), t(colors), t(opac), t(valid),
            H, W, t(bg))


@pytest.mark.parametrize("tile_x", [16, 32, 64])
def test_plain_matches_dense(tile_x):
    case = random_case(n=150, H=40, W=72, seed=tile_x)
    img_d, alpha_d = dense_reference(case)
    img, alpha, diag = rc.rasterize_cuda(*_torch_args(case), tile_x=tile_x,
                                         return_diagnostics=True)
    assert diag["dup_dropped"] == 0 and diag["tile_dropped"] == 0
    np.testing.assert_allclose(img.numpy(), np.asarray(img_d), atol=2e-4)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_d), atol=2e-4)


def test_plain_matches_dense_heavy_occlusion():
    """Near-opaque stacks: T saturates and the sticky stop decides."""
    n, H, W = 100, 32, 32
    rng = np.random.default_rng(3)
    case = (rng.uniform(2, 30, size=(n, 2)).astype(np.float32),
            rng.uniform(0.5, 5.0, size=(n,)).astype(np.float32),
            np.full(n, 24, np.int32),
            np.tile(np.asarray([[0.02, 0.0, 0.02]], np.float32), (n, 1)),
            rng.uniform(0, 1, size=(n, 4)).astype(np.float32),
            rng.uniform(0.9, 1.0, size=(n,)).astype(np.float32),
            np.ones(n, bool), H, W, np.asarray([0.3, 0.1, 0.2, 0.5], np.float32))
    img_d, alpha_d = dense_reference(case)
    img, alpha = rc.rasterize_cuda(*_torch_args(case), tile_x=16)
    assert float((alpha > 0.999).float().mean()) > 0.9  # mostly saturated
    np.testing.assert_allclose(img.numpy(), np.asarray(img_d), atol=2e-4)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_d), atol=2e-4)


def test_empty_scene_is_background():
    case = list(random_case(n=40, H=24, W=40, seed=5))
    case[6] = np.zeros_like(case[6])  # no valid splat
    img_d, _ = dense_reference(tuple(case))
    for n in (40, 0):  # all invalid, and no splats at all
        args = list(_torch_args(case))
        for i in range(7):
            args[i] = args[i][:n]
        img, alpha = rc.rasterize_cuda(*args, tile_x=32)
        np.testing.assert_array_equal(img.numpy(), np.asarray(img_d))
        assert (alpha == 0).all()


def _pallas_rows(case, chunk, tile_x):
    """The Pallas forward kernel's raw (num_tiles, 8, P) output, built as
    rasterize_pallas builds its inputs (interpret mode on the CPU)."""
    xys, depths, radii, conics, colors, opac, valid, H, W, _ = (
        jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in case)
    n = xys.shape[0]
    tiles_x, tiles_y = -(-W // tile_x), -(-H // 16)
    num_tiles = tiles_x * tiles_y
    bins = jax_bin(xys, depths, radii, valid, tiles_x, tiles_y, 16, chunk=chunk,
                   conics=conics, opacities=opac, tile_size_x=tile_x)
    per_splat = jnp.concatenate(
        [xys, conics, opac.reshape(-1, 1), colors, jnp.zeros((n, 6))], axis=1)
    table = jnp.concatenate([per_splat[bins.order], jnp.zeros((1, 16))])
    attr_rows = table[jnp.where(bins.entry_rank < 0, n, bins.entry_rank)]
    tid = jnp.arange(num_tiles, dtype=jnp.int32)
    sx, sy = (tid % tiles_x) * tile_x, (tid // tiles_x) * 16
    fns = rp._cached_pallas_fns(num_tiles, bins.entry_rank.shape[0], chunk,
                                min(8, num_tiles), tile_x)
    out = fns(attr_rows, bins.tile_starts, bins.counts, sx, sy)[:num_tiles]
    return np.asarray(out), np.asarray(bins.counts)


def test_plain_matches_pallas_rows():
    case = random_case(n=100, H=40, W=56, seed=0)
    chunk, tile_x = 32, 16
    ref, counts = _pallas_rows(case, chunk, tile_x)
    ti = rc.tile_inputs(*_torch_args(case)[:9], chunk=chunk, tile_x=tile_x)
    np.testing.assert_array_equal(ti.counts.numpy(), counts)
    got = rc.composite_fwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts,
                           ti.sx, ti.sy, tile_x).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got[:, 0:5], ref[:, 0:5], atol=1e-5, rtol=0)
    # The Pallas kernel also counts the pad slots of its last DMA window as
    # walked; clamped to the tile's count, the walked prefix is the same.
    np.testing.assert_array_equal(got[:, 5], np.minimum(ref[:, 5], counts[:, None]))
    np.testing.assert_array_equal(got[:, 6], ref[:, 6])
    assert (got[:, 7] == 0).all()
    # And the images agree through the rest of both pipelines.
    img_p, alpha_p = rp.rasterize_pallas(*(jnp.asarray(x) if isinstance(x, np.ndarray)
                                           else x for x in case), chunk=chunk)
    img, alpha = rc.rasterize_cuda(*_torch_args(case), chunk=chunk)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_p), atol=2e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_p), atol=2e-5)


def test_plain_spans_tile_blocks(monkeypatch):
    """Tiles split over several blocks of the plain walk."""
    monkeypatch.setattr(rc, "_PLAIN_BLOCK_ELEMS", 256 * 2)
    case = random_case(n=120, H=32, W=32, seed=7)
    img_d, alpha_d = dense_reference(case)
    img, alpha = rc.rasterize_cuda(*_torch_args(case), tile_x=16)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_d), atol=2e-4)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_d), atol=2e-4)


def test_argument_checks():
    case = random_case(n=20, H=16, W=16, seed=1)
    args = _torch_args(case)
    # 8-px tiles (square: tile_x 0) render the dense oracle's image.
    img_d, alpha_d = dense_reference(case)
    img, alpha = rc.rasterize_cuda(*args, tile_size=8)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_d), atol=2e-4)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_d), atol=2e-4)
    with pytest.raises(ValueError, match="row_offset"):  # a band outside the stride
        rc.rasterize_cuda(*args, row_stride=2, row_offset=2)
    with pytest.raises(ValueError):
        rc.rasterize_cuda(*args, tile_x=24)
    ti = rc.tile_inputs(*args[:9])
    with pytest.raises(TypeError):
        rc.composite_fwd(ti.table.double(), ti.entry_rank, ti.tile_starts, ti.counts,
                         ti.sx, ti.sy, ti.tile_x)
    with pytest.raises(TypeError):
        rc.composite_fwd(ti.table, ti.entry_rank.long(), ti.tile_starts, ti.counts,
                         ti.sx, ti.sy, ti.tile_x)
    with pytest.raises(ValueError):
        rc.composite_fwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts[:-1],
                         ti.sx, ti.sy, ti.tile_x)


def test_subtile_shape_checks():
    assert [rc.subtiles_per_tile(x) for x in (16, 32, 48, 64)] == [1, 2, 3, 4]
    for bad in (0, -16, 8, 24, 40):
        with pytest.raises(ValueError, match="sub-tile width"):
            rc.subtiles_per_tile(bad)
    ti = rc.tile_inputs(*_torch_args(random_case(n=20, H=16, W=48, seed=1))[:9], tile_x=48)
    with pytest.raises(ValueError, match="sub-tile width"):
        rc.composite_fwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, 24)


def test_warp_footprints_tile_the_subtiles():
    """8 x 4 warps: 32 pixels each, 8 per 16 x 16 sub-tile, none across a
    sub-tile edge."""
    assert rc.WARP_FOOTPRINT == (8, 4)
    for tile_x in (16, 48, 64):
        wid = rc.warp_ids(tile_x).numpy()
        pix = np.arange(16 * tile_x)
        lx, ly = pix % tile_x, pix // tile_x
        assert (np.bincount(wid) == 32).all()
        assert len(np.unique(wid)) == 8 * (tile_x // rc.SUB_X)
        for w in np.unique(wid):
            xs, ys = lx[wid == w], ly[wid == w]
            assert xs.max() - xs.min() == 7 and ys.max() - ys.min() == 3
            assert len(np.unique(xs // rc.SUB_X)) == 1


def test_nan_opacity_is_never_kept():
    """A NaN opacity gives a NaN alpha, which the alpha test never keeps (as
    torch.clamp has it, and the kernels since they cull by the same test):
    K1's plain version composites as if the opacity were 0, and the
    backward's rows are those of opacity 0, but NaN in the d-opacity column
    of the live entries whose opacity is NaN."""
    ti = rc.tile_inputs(*_torch_args(random_case(n=160, H=40, W=72, seed=6))[:9], tile_x=32)
    nan, zero = ti.table.clone(), ti.table.clone()
    nan[:-1:5, 5] = float("nan")
    zero[:-1:5, 5] = 0.0
    rest = (ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    out = rc.composite_fwd(nan, *rest, 32)
    assert torch.equal(out, rc.composite_fwd(zero, *rest, 32))
    gout = torch.from_numpy(np.random.default_rng(2).normal(size=tuple(out.shape))
                            .astype(np.float32))
    got = rc.composite_bwd(nan, *rest, out, gout, 32)
    ref = rc.composite_bwd(zero, *rest, out, gout, 32)
    is_nan = torch.isnan(got)
    assert not is_nan[:, :5].any() and not is_nan[:, 6:].any()
    assert torch.equal(got[:, :5], ref[:, :5]) and torch.equal(got[:, 6:], ref[:, 6:])
    ranks = ti.entry_rank.long()
    nan_entry = torch.isnan(nan[torch.where(ranks < 0, -1, ranks), 5])
    tile_live = torch.minimum(out[:, 6].amax(dim=1).long(), ti.counts.long())
    in_prefix = torch.zeros_like(nan_entry)
    for start, n in zip(ti.tile_starts.tolist(), tile_live.tolist()):
        in_prefix[start:start + n] = True
    assert is_nan[:, 5].any()
    assert torch.equal(is_nan[:, 5], nan_entry & in_prefix)


def test_subtile_live_and_work_order():
    case = random_case(n=160, H=40, W=100, seed=4)
    tile_x = 48
    ti = rc.tile_inputs(*_torch_args(case)[:9], tile_x=tile_x)
    out = rc.composite_fwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx,
                           ti.sy, tile_x)
    live = rc.subtile_live(out, ti.counts, tile_x)
    assert live.dtype == torch.int32 and tuple(live.shape) == (ti.counts.shape[0], 3)
    last = out[:, 6].numpy().reshape(-1, 16, tile_x)
    for t in range(live.shape[0]):
        for s in range(3):
            want = min(int(last[t, :, 16 * s:16 * s + 16].max()), int(ti.counts[t]))
            assert int(live[t, s]) == want, (t, s)
    assert len(np.unique(live.numpy())) > 3  # the sub-tiles differ
    order = rc.work_order(live)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(live.numel()))
    depth = live.reshape(-1)[order.long()]
    assert (depth[:-1] >= depth[1:]).all()
    for d in depth.unique():  # ties keep index order
        idx = order[depth == d]
        assert (idx[:-1] < idx[1:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tile_x", [16, 64])
def test_kernel_matches_plain_on_card(tile_x):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 has no CPU build")
    case = random_case(n=400, H=64, W=128, seed=tile_x)
    ti = rc.tile_inputs(*(x.cuda() if torch.is_tensor(x) else x
                          for x in _torch_args(case)[:9]), tile_x=tile_x)
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, tile_x)
    before = _build.launches["composite_fwd"]
    got = rc.composite_fwd(*args)
    assert _build.launches["composite_fwd"] == before + 1
    ref = rc.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[:, 0:5].cpu().numpy(), ref[:, 0:5].cpu().numpy(),
                               atol=1e-5, rtol=0)
    assert (got[:, 5:7] == ref[:, 5:7]).float().mean() >= 0.9999
