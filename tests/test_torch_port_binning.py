"""Port vs JAX package: ``bin_splats_dense``, compared exactly (CPU).

Both packages bin the SAME projected arrays (taken from the JAX projection,
so no float rounding of a radius can differ between frameworks). Entry
lists, depth order, tile ranges and every counter must be equal, with and
without the ellipse cull, at two tile widths, and when the per-tile,
entry and span capacities overflow.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.data.synthetic import orbit_cameras, random_gaussian_cloud
from tinysplat_tpu.ops.binning import bin_splats_dense as jax_bin
from tinysplat_tpu.ops.projection import project_gaussians

from tinysplat_torch.ops.binning import bin_splats_dense

from tests._torch_threads import one_torch_thread  # noqa: F401

W, H, N = 160, 96, 500


@functools.lru_cache(maxsize=1)
def _projected():
    means, log_scales, quats, _, opac_logits = random_gaussian_cloud(
        N, seed=4, scale_range=(0.01, 0.09))
    cam = orbit_cameras(3, width=W, height=H)[1]
    view, proj = cam.view_matrix, cam.proj_matrix
    p = project_gaussians(jnp.asarray(means), jnp.exp(jnp.asarray(log_scales)), 1.0,
                          jnp.asarray(quats), jnp.asarray(view), jnp.asarray(proj @ view),
                          cam.f_x, cam.f_y, W / 2.0, H / 2.0, H, W)
    opac = 1.0 / (1.0 + np.exp(-opac_logits.reshape(-1)))
    return {
        "xys": np.asarray(p.xys), "depths": np.asarray(p.depths),
        "radii": np.asarray(p.radii), "valid": np.asarray(p.valid),
        "conics": np.asarray(p.conics), "opacities": opac.astype(np.float32),
    }


def _bin_both(tile_x, clip, row_stride=1, row_offset=0, **caps):
    a = _projected()
    tiles_x, tiles_y = -(-W // tile_x), -(-H // 16) // row_stride
    static = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_size=16, chunk=32,
                  tile_size_x=tile_x, row_stride=row_stride, row_offset=row_offset, **caps)

    @functools.partial(jax.jit, static_argnames=("clip",))
    def ref_fn(xys, depths, radii, valid, conics, opacities, clip):
        extra = dict(conics=conics, opacities=opacities) if clip else {}
        return jax_bin(xys, depths, radii, valid, **static, **extra)

    ref = ref_fn(*(jnp.asarray(a[k]) for k in
                   ("xys", "depths", "radii", "valid", "conics", "opacities")), clip=clip)
    t = {k: torch.tensor(v) for k, v in a.items()}
    extra = dict(conics=t["conics"], opacities=t["opacities"]) if clip else {}
    got = bin_splats_dense(t["xys"], t["depths"], t["radii"], t["valid"], **static, **extra)
    return ref, got


def _assert_bins_equal(ref, got):
    # entry_rank whole: the kept entries and the -1 pad after them.
    for name in ("entry_rank", "order", "tile_starts", "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("num_entries", "total_intersections", "dup_overflow", "tile_overflow"):
        assert getattr(got, name) == int(getattr(ref, name)), name


@pytest.mark.parametrize("tile_x", [16, 64])
@pytest.mark.parametrize("clip", [False, True])
def test_bins_equal_jax(tile_x, clip):
    ref, got = _bin_both(tile_x, clip, max_per_tile=512)
    assert got.num_entries > 0 and got.dup_overflow == 0 and got.tile_overflow == 0
    _assert_bins_equal(ref, got)


@pytest.mark.parametrize("caps", [
    dict(max_per_tile=32),  # per-tile clamp
    dict(dup_capacity=256, span_capacity=4096),  # entry budget
    dict(dup_capacity=2048, span_capacity=96),  # span budget
], ids=["max_per_tile", "dup_capacity", "span_capacity"])
def test_bins_equal_jax_on_overflow(caps):
    ref, got = _bin_both(16, True, **caps)
    assert got.dup_overflow > 0 or got.tile_overflow > 0
    _assert_bins_equal(ref, got)


def test_empty_scene():
    t = {k: torch.tensor(v[:0]) for k, v in _projected().items()}
    got = bin_splats_dense(t["xys"], t["depths"], t["radii"], t["valid"], 4, 2,
                           conics=t["conics"], opacities=t["opacities"])
    assert got.num_entries == got.total_intersections == 0
    assert (got.entry_rank == -1).all() and (got.counts == 0).all()
    assert (got.tile_starts == 0).all()


def test_banding_not_ported():
    """Strided tile-row banding, ported since: each band of row stride 2
    (offsets 0 and 1; 3 of the image's 6 tile rows) bins exactly as the
    JAX package's, and the two bands hold every entry of the whole grid."""
    for tile_x, clip in ((16, True), (64, True), (16, False)):
        _, whole = _bin_both(tile_x, clip, max_per_tile=512)
        total = 0
        for offset in (0, 1):
            ref, got = _bin_both(tile_x, clip, row_stride=2, row_offset=offset,
                                 max_per_tile=512)
            assert got.num_entries > 0
            _assert_bins_equal(ref, got)
            total += got.total_intersections
        assert total == whole.total_intersections
    t = {k: torch.tensor(v) for k, v in _projected().items()}
    with pytest.raises(ValueError, match="row_offset"):
        bin_splats_dense(t["xys"], t["depths"], t["radii"], t["valid"], 4, 2,
                         row_stride=2, row_offset=2)
