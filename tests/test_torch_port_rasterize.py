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

from tinysplat_torch.ops import rasterize_cuda as rc

from test_rasterize_tiled import dense_reference, random_case


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
    args = _torch_args(random_case(n=20, H=16, W=16, seed=1))
    with pytest.raises(NotImplementedError):
        rc.rasterize_cuda(*args, tile_size=8)
    with pytest.raises(NotImplementedError):
        rc.rasterize_cuda(*args, row_stride=2)
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


@pytest.mark.cuda
@pytest.mark.parametrize("tile_x", [16, 64])
def test_kernel_matches_plain_on_card(tile_x):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 has no CPU build")
    case = random_case(n=400, H=64, W=128, seed=tile_x)
    ti = rc.tile_inputs(*(x.cuda() if torch.is_tensor(x) else x
                          for x in _torch_args(case)[:9]), tile_x=tile_x)
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy, tile_x)
    before = rc.composite_fwd.launches
    got = rc.composite_fwd(*args)
    assert rc.composite_fwd.launches == before + 1
    ref = rc.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[:, 0:5].cpu().numpy(), ref[:, 0:5].cpu().numpy(),
                               atol=1e-5, rtol=0)
    assert (got[:, 5:7] == ref[:, 5:7]).float().mean() >= 0.9999
