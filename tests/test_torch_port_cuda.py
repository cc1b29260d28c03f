"""The port's CUDA kernels against their plain PyTorch versions, on the card.

JAX-free, so that it runs where only the port and CUDA torch are
installed: ``python -m pytest tests/test_torch_port_cuda.py`` on a GPU.
Every test is marked ``cuda`` and skips where torch sees no CUDA device.

Tolerances: K1 bit for bit (the same float32 ops in the same order); K2's
per-entry rows to 1e-5 x the column's max |plain| (the masks are K1's bit
for bit; only the order of the pixel sums and K2's fused multiply-adds in
the gradient terms differ), and two K2 launches byte for byte; K3 bit for
bit, and two launches byte for byte (it adds each run in the plain
version's order, with no atomics); ``scatter_rows`` against a float64
``index_add_`` of the same rows, each splat's row within the float32
rounding of its adds in any order (its atomics change order from launch to
launch), the sentinel row exactly 0. The probes: P1 bit for
bit (it moves bits as integers); P2 per row, as ``op_costs.TOLERANCE``
states with its reasons. SSIM's L1 and L2 as ``ssim_cuda.TOL`` states,
and two launches byte for byte.
"""
import numpy as np
import pytest
import torch

from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.ops import _build
from tinysplat_torch.ops import rasterize_cuda as rc
from tinysplat_torch.ops import splat_inputs_cuda as si
from tinysplat_torch.ops import ssim_cuda as sc
from tinysplat_torch.ops.sh import SH_C0, eval_sh
from tinysplat_torch.probes import bitcast, op_costs

# By its bare name (pytest puts tests/ on the path): an installed package
# named ``tests`` would shadow this directory's ``tests.`` prefix.
from _torch_threads import one_torch_thread  # noqa: F401


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")


def _splats(rng, n, lo, hi, cov=None, opacity=(0.05, 1.0), depth=(0.5, 5.0)):
    """n random screen-space splats: xys, depths, covariances, colours, opacities."""
    xys = rng.uniform(lo, hi, size=(n, 2))
    if cov is None:
        L = rng.normal(size=(n, 2, 2)) * 2.0
        cov = L @ np.swapaxes(L, 1, 2) + np.eye(2)
    else:
        cov = np.tile(np.asarray(cov, np.float64), (n, 1, 1))
    return (xys, rng.uniform(*depth, size=n), cov, rng.uniform(0, 1, (n, 4)),
            rng.uniform(*opacity, size=n))


def _inputs(parts, height, width, tile_x, seed, tile_h=16, **caps):
    """Compositing inputs on the card for the splat sets ``parts`` at
    tile_h x tile_x tiles, K1's output and a numpy-drawn cotangent of its
    rows 0-4."""
    _need_card()
    xys, depths, cov, colors, opac = (np.concatenate(x) for x in zip(*parts))
    inv = np.linalg.inv(cov)
    radii = np.ceil(3.5 * np.sqrt(np.linalg.eigvalsh(cov).max(axis=1)))
    rng = np.random.default_rng(seed)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    ti = rc.tile_inputs(
        cuda(xys), cuda(depths), cuda(radii, torch.int32),
        cuda(np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], axis=1)), cuda(colors),
        cuda(opac), cuda(rng.uniform(size=len(opac)) > 0.05, torch.bool), height, width,
        tile_x=tile_x, tile_h=tile_h, **caps)
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    out = rc.composite_fwd(*args, tile_x, tile_h)
    gout = torch.zeros_like(out)
    gout[:, 0:5] = cuda(rng.normal(size=tuple(out[:, 0:5].shape)))
    return ti, args, out, gout


def _case(n, height, width, tile_x, seed, tile_h=16):
    """n random splats over a height x width image."""
    rng = np.random.default_rng(seed)
    return _inputs([_splats(rng, n, (-6, -6), (width + 6, height + 6))], height, width,
                   tile_x, seed, tile_h)


def _deep_case(tile_x, tile_h=16):
    """One tile_h x tile_x tile under 1,500 faint wide splats (deeper than
    two K1 batches of 256 entries), and 160 opaque ones in front of its
    first sub-tile only: the first sub-tile's live prefix ends early, the
    others' run deep."""
    rng = np.random.default_rng(tile_x + tile_h)
    faint = _splats(rng, 1500, (0, 0), (tile_x, tile_h), cov=[[400, 0], [0, 400]],
                    opacity=(0.004, 0.008), depth=(1.0, 5.0))
    front = _splats(rng, 160, (0, 0), (16, 16), cov=[[16, 0], [0, 16]], opacity=(0.95, 1.0),
                    depth=(0.1, 0.5))
    return _inputs([faint, front], tile_h, tile_x, tile_x, tile_x + 1, tile_h,
                   max_per_tile=4096)


# name -> inputs: mixed scenes at every tile width and at tile heights other
# than 16 (the image 100 x 160, a multiple of none of 8, 12, 16 and 32: the
# last tiles, and at 12 and 32 px the last sub-tiles, are ragged), and the
# deep tiles whose sub-tiles end apart.
CASES = {
    **{f"mixed tile_x={x}": (lambda x=x: _case(700, 100, 160, x, seed=x)) for x in (16, 32, 48, 64)},
    **{f"mixed {h}x{x}": (lambda h=h, x=x: _case(700, 100, 160, x, seed=h + x, tile_h=h))
       for h, x in ((8, 8), (12, 12), (32, 32), (32, 64), (8, 64))},
    "deep tile_x=64": lambda: _deep_case(64),
    "deep tile_x=48": lambda: _deep_case(48),
    "deep 32x32": lambda: _deep_case(32, 32),
}
DEEP = ("deep tile_x=64", "deep tile_x=48", "deep 32x32")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_k1_bit_equal_to_plain(name):
    ti, args, out, _ = CASES[name]()
    before = _build.launches["composite_fwd"]
    got = rc.composite_fwd(*args, ti.tile_x, ti.tile_h)
    assert _build.launches["composite_fwd"] == before + 1
    ref = rc.composite_fwd_plain(*args, ti.tile_x, ti.tile_h)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got, out)  # and launch after launch


@pytest.mark.cuda
def test_deep_cases_are_deep_and_uneven():
    for name in DEEP:
        ti, _, out, _ = CASES[name]()
        assert int(ti.counts.max()) > 2 * rc.SUB_THREADS, name
        live = rc.subtile_live(out, ti.counts, ti.tile_x, ti.tile_h)[0]
        assert int(live[0]) * 4 < int(live[1:].min()), (name, live.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_k2_matches_plain(name):
    ti, args, out, gout = CASES[name]()
    before = _build.launches["composite_bwd"]
    got = rc.composite_bwd(*args, out, gout, ti.tile_x, ti.tile_h)
    assert _build.launches["composite_bwd"] == before + 1
    again = rc.composite_bwd(*args, out, gout, ti.tile_x, ti.tile_h)
    ref = rc.composite_bwd_plain(*args, out, gout, ti.tile_x, ti.tile_h)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    assert float(((got - ref).abs() / scale).max()) <= 1e-5
    assert (ref.abs().amax(dim=1) > 0).sum() > 100  # a live prefix was compared


def _very_deep_case(n, max_per_tile):
    """One 16 x 64 tile under ``n`` faint wide splats, more than 4096 deep:
    the per-tile budgets of the GT renders of the quality tools (8192 in
    quality_bench and train_1m_probe, 16384 in train_diffusion_prior and
    diffusion_ab). Most (entry, pixel) pairs fall under the alpha floor,
    so the walk stays live far into the tile."""
    rng = np.random.default_rng(n)
    faint = _splats(rng, n, (0, 0), (64, 16), cov=[[400, 0], [0, 400]],
                    opacity=(0.0040, 0.0045), depth=(1.0, 5.0))
    return _inputs([faint], 16, 64, 64, n + 1, max_per_tile=max_per_tile)


@pytest.mark.cuda
@pytest.mark.parametrize("n,max_per_tile", [(6000, 8192), (12000, 16384)])
def test_k1_k2_match_plain_past_4096_entries(n, max_per_tile):
    ti, args, out, gout = _very_deep_case(n, max_per_tile)
    assert 4096 < int(ti.counts.max()) <= max_per_tile
    assert int(ti.bins.tile_overflow) == 0
    ref = rc.composite_fwd_plain(*args, ti.tile_x)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert int(out[:, 6].max()) > 4096  # pixels composite entries past 4096
    got = rc.composite_bwd(*args, out, gout, ti.tile_x)
    again = rc.composite_bwd(*args, out, gout, ti.tile_x)
    ref_b = rc.composite_bwd_plain(*args, out, gout, ti.tile_x)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    scale = ref_b.abs().amax(dim=0).clamp(min=1e-30)
    assert float(((got - ref_b).abs() / scale).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [2, 4])
def test_banded_k1_k2_match_plain(stride):
    """K1 and K2 on the strided bands of the sharded trainer (tile rows
    {o, o + S, ...} of a 128 px tall image, xys in global pixels): the
    tiles' pixel origins are global rows, K1 equals its plain version bit
    for bit, K2 to 1e-5 x column max and byte for byte across two launches,
    and each band's tiles equal the whole image's tiles of the same rows."""
    caps = dict(max_per_tile=4096, dup_capacity=1 << 16)
    for tile_x in (16, 64):
        rng = np.random.default_rng(40 + stride)
        parts = [_splats(rng, 700, (-6, -6), (166, 134))]
        whole, _, whole_out, _ = _inputs(parts, 128, 160, tile_x, 7, **caps)
        for offset in range(stride):
            ti, args, out, gout = _inputs(parts, 128 // stride, 160, tile_x, 7,
                                          row_stride=stride, row_offset=offset, **caps)
            rows = torch.arange(ti.tiles_y, device="cuda") * stride + offset
            assert torch.equal(ti.sy.reshape(ti.tiles_y, ti.tiles_x)[:, 0], rows * 16)
            assert torch.equal(out, rc.composite_fwd_plain(*args, tile_x))
            tiles = whole_out.reshape(whole.tiles_y, whole.tiles_x, *out.shape[1:])[rows]
            assert torch.equal(out, tiles.reshape(out.shape))
            got = rc.composite_bwd(*args, out, gout, tile_x)
            again = rc.composite_bwd(*args, out, gout, tile_x)
            ref = rc.composite_bwd_plain(*args, out, gout, tile_x)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), again.view(torch.int32))
            scale = ref.abs().amax(dim=0).clamp(min=1e-30)
            assert float(((got - ref).abs() / scale).max()) <= 1e-5
            assert (ref.abs().amax(dim=1) > 0).sum() > 100


@pytest.mark.cuda
def test_nan_opacity_matches_plain():
    """Splats with a NaN opacity: NaN alpha, never kept (as torch.clamp has
    it). K1 equals its plain version and its output at opacity 0; K2 matches
    its plain version, NaN in the same places (the d-opacity column of the
    NaN entries in the live prefix)."""
    ti, args, _, gout = _case(700, 100, 160, 64, seed=5)
    nan, zero = ti.table.clone(), ti.table.clone()
    nan[:-1:5, 5] = float("nan")
    zero[:-1:5, 5] = 0.0
    out = rc.composite_fwd(nan, *args[1:], 64)
    assert torch.equal(out, rc.composite_fwd_plain(nan, *args[1:], 64))
    assert torch.equal(out, rc.composite_fwd(zero, *args[1:], 64))
    got = rc.composite_bwd(nan, *args[1:], out, gout, 64)
    again = rc.composite_bwd(nan, *args[1:], out, gout, 64)
    ref = rc.composite_bwd_plain(nan, *args[1:], out, gout, 64)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    is_nan = torch.isnan(ref)
    assert is_nan[:, 5].any() and not is_nan[:, :5].any() and not is_nan[:, 6:].any()
    assert torch.equal(torch.isnan(got), is_nan)
    ref, got = ref.nan_to_num(0.0), got.nan_to_num(0.0)
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    assert float(((got - ref).abs() / scale).max()) <= 1e-5


def _k3_bit_equal(rows, perm, bounds):
    """K3 twice and its plain version on the same inputs: one launch each,
    the same bytes every time."""
    before = _build.launches["segsum"]
    got = rc.segsum(rows, perm, bounds)
    assert _build.launches["segsum"] == before + 1
    again = rc.segsum(rows, perm, bounds)
    ref = rc.segsum_plain(rows, perm, bounds)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    return got


@pytest.mark.cuda
def test_k3_matches_plain_and_every_reduction_agrees():
    ti, args, out, gout = _case(600, 64, 128, 64, seed=3)
    rows = rc.composite_bwd(*args, out, gout, 64)
    n = ti.table.shape[0] - 1
    perm, bounds = rc.segsum_inputs(ti.entry_rank, n)
    _k3_bit_equal(rows, perm, bounds)
    ref = rc.reduce_entry_grads(rows, ti.entry_rank, n, "scatter")
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    for strategy in rc.GRAD_REDUCE:
        red = rc.reduce_entry_grads(rows, ti.entry_rank, n, strategy)
        assert float(((red - ref).abs() / scale).max()) <= 1e-5, strategy


def _k3_case(lengths, pads, seed):
    """K3's inputs on the card for splats with the given run lengths and
    ``pads`` pad entries, in a random entry order; rows of magnitudes
    1e-3..1e3, so the order of the adds shows in the low bits."""
    _need_card()
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    m = len(lengths)
    ids = np.concatenate([np.repeat(np.arange(m), lengths), np.full(pads, -1)])
    ids = rng.permutation(ids).astype(np.int32)
    rows = rng.normal(size=(len(ids), 10)) * 10.0 ** rng.uniform(-3, 3, (len(ids), 1))
    rows = torch.as_tensor(rows, dtype=torch.float32, device="cuda")
    perm, bounds = rc.segsum_inputs(torch.as_tensor(ids, device="cuda"), m)
    return rows, perm, bounds


def _clamped_case():
    """Bounds below 0 and past D, and a random permutation."""
    _need_card()
    rng = np.random.default_rng(7)
    d = 3000
    rows = torch.as_tensor(rng.normal(size=(d, 10)), dtype=torch.float32, device="cuda")
    perm = torch.as_tensor(rng.permutation(d), dtype=torch.int32, device="cuda")
    bounds = np.sort(rng.integers(-200, d + 300, size=601))
    return rows, perm, torch.as_tensor(bounds, dtype=torch.int32, device="cuda")


def _lengths(seed, m, hi=4):
    return np.random.default_rng(seed).integers(0, hi, size=m)


# name -> K3 inputs. K3 runs a block per 256 splat ids, a thread per splat,
# and a warp steps as long as its longest run (csrc/segsum.cu).
K3_CASES = {
    # runs of 700 and 1,500 rows beside short ones in the same warps
    "long runs": lambda: _k3_case(
        np.concatenate([[700], _lengths(1, 100), [1500], _lengths(2, 200)]), 50, 1),
    # 256 splats of 5 rows: 1,280 rows in the first block, an odd run length
    "a block of 1,280 rows": lambda: _k3_case(
        np.concatenate([np.full(256, 5), _lengths(3, 512)]), 40, 2),
    "all-dead blocks": lambda: _k3_case(
        np.concatenate([_lengths(4, 256), np.zeros(512, int), _lengths(5, 256)]), 30, 3),
    "M not a multiple of 256": lambda: _k3_case(_lengths(6, 1000), 100, 4),
    "M = 1": lambda: _k3_case([37], 5, 5),
    "only pad rows": lambda: _k3_case(np.zeros(500, int), 300, 6),
    "clamped bounds": _clamped_case,
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_bit_equal_to_plain(name):
    rows, perm, bounds = K3_CASES[name]()
    got = _k3_bit_equal(rows, perm, bounds)
    if name == "only pad rows":
        assert (got == 0).all()


@pytest.mark.cuda
def test_k3_rejects_unaligned_rows():
    _need_card()
    flat = torch.zeros(1 + 8 * 10, device="cuda")
    rows = flat[1:].view(8, 10)  # contiguous, 4 bytes past an 8-byte boundary
    perm = torch.arange(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="8-byte boundary"):
        rc.segsum(rows, perm, torch.tensor([0, 8], dtype=torch.int32, device="cuda"))


def _smoke():
    """``chip_smoke`` (JAX-free, at the repository root), whose phase 20
    builds the bench layouts and holds ``scatter_rows`` to its bound."""
    import chip_smoke

    return chip_smoke


def _bench_layout(config):
    """(rows, ranks, n): K2's rows over a benchmark configuration's entries,
    every pad slot of its budget kept (``chip_smoke.bench_layout``). The
    scene comes from the benchmark's own generator (``splatbench/inputs.py``
    and the configuration's JSON), so a change there changes the layout
    this test holds the kernel to."""
    _need_card()
    return _smoke().bench_layout(torch, rc, config)


def _scatter_case(d, n, seed, live=0.3, hot=0):
    """d slots: a ``live`` share ranked in [0, n), the rest -1 or n..n + 2,
    and ``hot`` more slots all ranked 3; rows of magnitudes 1e-3..1e3, so
    the order of the adds shows in the low bits."""
    _need_card()
    rng = np.random.default_rng(seed)
    kind = rng.uniform(size=d)
    ranks = np.where(kind < live, rng.integers(0, max(n, 1), size=d), -1)
    ranks = np.where(kind > 1 - (1 - live) / 3, n + rng.integers(0, 3, size=d), ranks)
    ranks = rng.permutation(np.concatenate([ranks, np.full(hot, 3)])).astype(np.int32)
    rows = rng.normal(size=(len(ranks), 10)) * 10.0 ** rng.uniform(-3, 3, (len(ranks), 1))
    return (torch.as_tensor(rows, dtype=torch.float32, device="cuda"),
            torch.as_tensor(ranks, device="cuda"), n)


# name -> (rows, ranks, n) for scatter_rows. The kernel takes 32 slots a warp
# and 256 a block (csrc/scatter_rows.cu).
SCATTER_CASES = {
    "262k bench scene": lambda: _bench_layout("splats-262k"),
    "1M bench scene": lambda: _bench_layout("splats-1m"),
    "ranks -1, n and above": lambda: _scatter_case(10_000, 500, 1),
    "E = 0": lambda: _scatter_case(4096, 100, 2, live=0.0),
    "n = 0": lambda: _scatter_case(3000, 0, 3),
    "D not a multiple of the block": lambda: _scatter_case(256 * 37 + 77, 900, 4),
    "one splat in 5,000 slots": lambda: _scatter_case(2000, 50, 5, hot=5000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCATTER_CASES))
def test_scatter_rows_matches_a_float64_index_add(name):
    """One launch; the sentinel row exactly 0; each splat's row within the
    float32 rounding of its k adds in any order, as the atomics' order
    changes from launch to launch (``chip_smoke.scatter_rows_holds``)."""
    rows, ranks, n = SCATTER_CASES[name]()
    before = _build.launches["scatter_rows"]
    got = rc.scatter_rows(rows, ranks, n)
    assert _build.launches["scatter_rows"] == before + 1
    torch.cuda.synchronize()
    assert got.shape == (n + 1, 10) and got.dtype == torch.float32
    assert (got[n].view(torch.int32) == 0).all()
    ratio, _, live = _smoke().scatter_rows_holds(torch, rows, ranks.long(), n, got)
    assert ratio <= 1.0
    if name.endswith("bench scene"):
        assert live < ranks.shape[0] // 2  # most of the budget is pads
    if name in ("E = 0", "n = 0"):
        assert (got.view(torch.int32) == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["4 bytes past an 8-byte boundary", "not contiguous"])
def test_scatter_rows_rejects_what_the_kernel_does_not_take(layout):
    _need_card()
    if layout == "not contiguous":
        rows = torch.zeros((8, 20), device="cuda")[:, ::2]
        match = "contiguous"
    else:
        rows = torch.zeros(1 + 8 * 10, device="cuda")[1:].view(8, 10)
        match = "8-byte boundary"
    with pytest.raises(ValueError, match=match):
        rc.scatter_rows(rows, torch.zeros(8, dtype=torch.int32, device="cuda"), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", bitcast.VARIANTS)
def test_p1_bitcast_exact_and_equal_to_plain(variant):
    _need_card()
    gt = bitcast.ground_truth()
    x = bitcast.variant_input(variant, gt, "cuda")
    before = _build.launches["probe_bitcast"]
    got = bitcast.probe_bitcast(variant, x)
    assert _build.launches["probe_bitcast"] == before + 1
    torch.cuda.synchronize()
    assert bitcast.exact(variant, got, gt)
    assert bitcast.same_bits(got, bitcast.probe_bitcast_plain(variant, x))
    xt, offsets = bitcast.table_case(variant, 4096, "cuda")
    assert bitcast.same_bits(bitcast.probe_bitcast(variant, xt, offsets),
                             bitcast.probe_bitcast_plain(variant, xt, offsets))


@pytest.mark.cuda
def test_p1_bitcast_rejects_unaligned_input():
    _need_card()
    flat = torch.zeros(2 + 8 * 32, dtype=torch.int16, device="cuda")
    x = flat[2:].view(8, 32)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte boundary"):
        bitcast.probe_bitcast("A", x)


@pytest.mark.cuda
@pytest.mark.parametrize("op", op_costs.OPS)
def test_p2_op_costs_match_plain(op):
    _need_card()
    x = op_costs.tile(128, "cuda")
    before = _build.launches["probe_op_costs"]
    got = op_costs.probe_op_costs(op, x)
    assert _build.launches["probe_op_costs"] == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = op_costs.TOLERANCE.get(op, 0.0)
    assert op_costs.rel_err(got, op_costs.probe_op_costs_plain(op, x)) <= tol
    if op in op_costs.TRI:  # after one pass, before the values underflow
        one = op_costs.probe_op_costs(op, x, 1)
        assert float(one.abs().max()) > 0.1
        assert op_costs.rel_err(one, op_costs.probe_op_costs_plain(op, x, 1)) <= tol


# -- slice E on the card: the KNN and the Poisson solve stay on the device ------------


@pytest.mark.cuda
def test_knn_on_the_card_equals_the_cpu_with_ties():
    """The chunked KNN on CUDA tensors against the CPU's: neighbour
    distances (float64, sorted) to 1e-5 relative (cuBLAS and the CPU round
    the products differently, so near ties may swap), and copies of one
    splat (exact ties) resolved to the lower indices: a chosen copy's live
    lower-indexed twins are chosen too."""
    _need_card()
    from tinysplat_torch.regularizers.density import knn_indices

    rng = np.random.default_rng(3)
    means = rng.normal(size=(3000, 3)).astype(np.float32) + 5.0
    means[2000:2400] = np.repeat(means[:100], 4, axis=0)  # 4 copies each of 100
    alive = rng.uniform(size=3000) > 0.1
    pts = np.concatenate([means[:100] + 0.01, rng.normal(size=(900, 3)) + 5.0]).astype(
        np.float32)
    args = [torch.from_numpy(x) for x in (pts, means, alive)]
    want = knn_indices(*args, k=16, chunk=128)
    got = knn_indices(*(x.cuda() for x in args), k=16, chunk=128)
    assert got.is_cuda
    got = got.cpu().numpy()

    def dists(idx):
        return np.sort(np.linalg.norm(pts[:, None].astype(np.float64) - means[idx], axis=-1), 1)

    np.testing.assert_allclose(dists(got), dists(want.numpy()), rtol=1e-5)
    group = np.arange(3000)
    group[2000:2400] = np.repeat(np.arange(100), 4)  # copy -> its original
    for row in got:
        for j in row:
            twins = np.nonzero((group == group[j]) & alive & (np.arange(3000) < j))[0]
            assert set(twins) <= set(row), (row, j, twins)


@pytest.mark.cuda
def test_poisson_solve_stays_on_the_card():
    _need_card()
    from tinysplat_torch import poisson

    p = np.random.default_rng(0).normal(size=(3000, 3))
    p = torch.as_tensor(p / np.linalg.norm(p, axis=1, keepdims=True) * 0.7,
                        dtype=torch.float32, device="cuda")
    chi, origin, _, iso = poisson.solve_indicator(p, p / p.norm(dim=1, keepdim=True),
                                                  resolution=32)
    assert chi.is_cuda and origin.is_cuda and np.isfinite(iso)
    cpu = poisson.solve_indicator(p.cpu(), (p / p.norm(dim=1, keepdim=True)).cpu(),
                                  resolution=32)[0]
    assert float((chi.cpu() - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())


def _tiny_pipelines():
    """The tiny pipeline (latent 4, default widths otherwise) on the CPU and
    on the card, with the same weights, and one view's inputs."""
    from tinysplat_torch.data.synthetic import orbit_cameras
    from tinysplat_torch.diffusion.pipeline import TinysplatDiffusionPipeline, stack_cameras

    cpu = TinysplatDiffusionPipeline.tiny(sample_size=4,
                                          generator=torch.Generator().manual_seed(1),
                                          device="cpu")
    card = TinysplatDiffusionPipeline.tiny(sample_size=4,
                                           generator=torch.Generator().manual_seed(1))
    cams = orbit_cameras(3, width=40, height=30)
    rng = np.random.default_rng(2)
    init = torch.as_tensor(rng.uniform(-1, 1, (1, 3, 32, 32)), dtype=torch.float32)
    imgs = torch.as_tensor(rng.uniform(0, 1, (1, 2, 3, 8, 8)), dtype=torch.float32)
    eps = torch.as_tensor(rng.normal(size=(1, 4, 4, 4)), dtype=torch.float32)
    noise = torch.as_tensor(rng.normal(size=(1, 4, 4, 4)), dtype=torch.float32)

    def inputs(dev):
        tg, cin = stack_cameras(cams[:1], dev), stack_cameras([cams[1:]], dev)
        return (init.to(dev), tg, cin, imgs.to(dev)), dict(eps=eps.to(dev), noise=noise.to(dev))

    return cpu, card, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("strength", [0.0, 0.6, 1.0])
def test_tiny_diffusion_pipeline_on_the_card_matches_the_cpu(strength):
    """The same weights and draws: within 1e-4 x max (TF32 off on the card;
    the convolution algorithms differ)."""
    _need_card()
    cpu, card, inputs = _tiny_pipelines()
    args, draws = inputs("cpu")
    want = cpu(*args, num_inference_steps=8, strength=strength, **draws)
    args, draws = inputs("cuda")
    got = card(*args, num_inference_steps=8, strength=strength, **draws)
    assert got.is_cuda and got.shape == want.shape == (1, 3, 32, 32)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_diffusion_forward_runs_without_tf32_and_restores_the_flags():
    _need_card()
    _, card, inputs = _tiny_pipelines()
    seen = []
    card.unet.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        args, draws = inputs("cuda")
        card(*args, num_inference_steps=4, strength=1.0, **draws)
        assert seen and set(seen) == {(False, False)}
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def _splat_case(n, stored_deg, seed):
    """S1's inputs on the card: n random splats with SH degree ``stored_deg``
    (a tenth of them dead) before an orbit camera with a principal-point
    offset, a 76 x 100 image and 12-px tiles (1/12 is inexact, as torch's
    product with a host scalar's reciprocal is); odd degrees take the true
    camera position, degrees from 2 on the antialiased opacities."""
    _need_card()
    rng = np.random.default_rng(seed)
    kb = (stored_deg + 1) ** 2

    def cuda(x):
        return torch.as_tensor(np.asarray(x, np.float32), device="cuda")

    cam = orbit_cameras(3, width=100, height=76)[1].params(device="cuda")
    args = (cuda(rng.normal(0.0, 0.8, (n, 3))), cuda(rng.uniform(-4.0, -1.5, (n, 3))),
            cuda(rng.normal(size=(n, 4))), cuda(rng.normal(0.0, 1.0, (n, 3))),
            cuda(rng.normal(0.0, 0.3, (n, kb - 1, 3))), cuda(rng.normal(0.0, 2.0, (n, 1))),
            torch.as_tensor(rng.uniform(size=n) > 0.1, device="cuda"), cam.viewmat,
            cam.projmat @ cam.viewmat, cam.cam_pos, cam.fx, cam.fy, cuda(1.5), cuda(-2.25))
    layout = si.SplatLayout(100, 76, 12, "position" if stored_deg % 2 else "reference",
                            stored_deg >= 2)
    return args, layout


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 255, 257])
def test_s1_matches_plain(n, deg):
    args, layout = _splat_case(n, deg, seed=10 * n + deg)
    for active in sorted({deg, max(deg - 1, 0)}):
        before = _build.launches["splat_fwd"]
        got = si.splat_fwd(*args, active, layout)
        assert _build.launches["splat_fwd"] == before + 1
        ref = si.splat_fwd_plain(*args, active, layout)
        torch.cuda.synchronize()
        report = si.forward_mismatch(got, ref, layout.tile_size)
        assert report["ok"], str(report)


def _off_the_kink(args, bargs):
    """``bargs`` with the colour cotangent zeroed where maximum(v, 0) is at
    its kink, and the original cotangent there.

    S1's fused multiply-add chain and the plain version's einsum sum the SH
    colour v in different orders (FWD_TOL): where the plain v lies within
    FWD_TOL x its column max of 0, the two may fall on different sides of
    the kink (an exact tie in one, 1e-7 in the other), and each backward
    then takes its own forward's subgradient. S2 must take S1's: the caller
    checks that at these channels, and holds S2 to the plain version
    everywhere else."""
    deg, layout, g_colors4 = bargs[11], bargs[12], bargs[16]
    origin = si.view_origin(args[7], args[9], layout.viewdirs_mode)
    v = eval_sh(deg, si.view_directions(args[0], origin),
                torch.cat([args[3][:, None, :], args[4]], dim=1)) + 0.5
    kink = torch.zeros_like(g_colors4, dtype=torch.bool)
    kink[:, :3] = v.abs() <= si.FWD_TOL * v.abs().amax(dim=0)
    off = list(bargs)
    off[16] = torch.where(kink, 0.0, g_colors4)
    return off, kink


def _s2_holds(args, bargs, n):
    """S2 on ``bargs`` (without and with the camera gradient): one launch
    counted, the same bytes twice, within BWD_TOL of its plain version off
    maximum's kink, and at the kink S1's subgradient. Returns the gradients
    with the camera's."""
    off, kink = _off_the_kink(args, bargs)
    assert int(kink.sum()) <= 8  # an ulp of a colour from 0: rare
    if kink.any():
        g_dc = si.splat_bwd(*bargs, False)[3]
        colour = si.splat_fwd(*args, bargs[11], bargs[12]).colors4[:, :3]
        c0 = torch.tensor(SH_C0, dtype=torch.float32, device="cuda")
        for j, ch in kink[:, :3].nonzero().tolist():
            g = bargs[16][j, ch]
            sides = [c0 * g] if colour[j, ch] > 0 else [c0 * (g / 2), c0 * 0.0]
            assert any(torch.equal(g_dc[j, ch], x) for x in sides), (j, ch)
    for cam_grad in (False, True):
        before = _build.launches["splat_bwd"]
        got = si.splat_bwd(*off, cam_grad)
        assert _build.launches["splat_bwd"] == before + 1
        again = si.splat_bwd(*off, cam_grad)
        ref = si.splat_bwd_plain(*off, cam_grad)
        torch.cuda.synchronize()
        assert (got[6] is None) == (again[6] is None) == (not cam_grad)
        for a, b in zip(got, again):
            if a is not None:
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        report = si.backward_mismatch(got, ref, per_column=n > 1)
        assert report["ok"], str(report)
    return got


def _s2_args(n, deg):
    """S1's arguments of ``_splat_case`` and S2's: those with the degree,
    the layout and a numpy-drawn cotangent."""
    args, layout = _splat_case(n, deg, seed=10 * n + deg)
    rng = np.random.default_rng(n + deg)
    cot = [torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
           for shape in ((n, 2), (n,), (n, 3), (n, 4), (n,))]
    return args, (*args[:6], *args[7:12], deg, layout, *cot)


# S2's blocks hold 128 splats: 127-129 straddle a block's edge; 70,001 leaves
# a ragged last block of 113 splats, whose span of colors_rest ends off a
# 16-byte boundary at degrees 1 and 3, and gives the camera fold 547 rows.
@pytest.mark.cuda
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 255, 257, 70_001])
def test_s2_matches_plain_and_repeats(n, deg):
    _s2_holds(*_s2_args(n, deg), n)


# colors_rest as a contiguous view 4 or 12 bytes past a 16-byte boundary: S2
# copies its span in and g_rest out through the 4-byte path at the ends and
# must give the bytes it gives for the same values at an aligned address.
@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("deg", [1, 2, 3, 4])
def test_s2_takes_colors_rest_at_any_offset(deg, offset):
    n = 1_001
    args, bargs = _s2_args(n, deg)
    bargs = list(bargs)
    rest = bargs[4]
    store = torch.full((rest.numel() + 8,), float("nan"), device="cuda")
    view = store[offset:offset + rest.numel()].view(rest.shape)
    view.copy_(rest)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset
    aligned = _s2_holds(args, bargs, n)
    bargs[4] = view
    shifted = _s2_holds(args, bargs, n)
    for a, b in zip(aligned, shifted):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))



# --- B1-B4: tile binning (csrc/binning.cu) ------------------------------------
# Every integer output bit for bit against the plain version on the card,
# stage by stage and whole (binning_cuda.stage_mismatch), and two runs of
# the kernels byte for byte.
BIN_W, BIN_H, BIN_N = 640, 400, 20_000


def _bin_splats(seed, n=BIN_N, width=BIN_W, height=BIN_H):
    """numpy splats on the card: on and far off the image, invalid ones with
    non-finite positions, opacities below 1/255, exact depth ties."""
    rng = np.random.default_rng(seed)
    xys = rng.uniform(-40, [width + 40, height + 40], size=(n, 2))
    far = rng.choice(n, n // 50, replace=False)
    xys[far] = rng.choice([-1e9, 1e9, 3e7, 3e38], size=(len(far), 2))
    depths = rng.uniform(0.5, 5.0, n)
    depths[rng.choice(n, n // 10, replace=False)] = 2.0
    radii = rng.integers(0, 64, n)
    valid = rng.uniform(size=n) > 0.1
    xys[rng.choice(np.flatnonzero(~valid), 20, replace=False)] = np.nan
    L = rng.normal(size=(n, 2, 2)) * rng.uniform(0.5, 6.0, (n, 1, 1))
    inv = np.linalg.inv(L @ np.swapaxes(L, 1, 2) + np.eye(2))
    conics = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], axis=1)
    opac = rng.uniform(0.0, 1.0, n)
    opac[rng.choice(n, n // 10, replace=False)] = rng.uniform(0.0, 1.0 / 255.0, n // 10)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    return (cuda(xys), cuda(depths), cuda(radii, torch.int32), cuda(valid, torch.bool),
            cuda(conics), cuda(opac))


# name: (tile_h, tile_x, row_stride, row_offset, ellipse cull, capacities)
BIN_CASES = {
    "16x64": (16, 64, 1, 0, True, {}),
    "8x8": (8, 8, 1, 0, True, {}),
    "12x12": (12, 12, 1, 0, True, {}),
    "32x32": (32, 32, 1, 0, True, {}),
    "16x16 rect": (16, 16, 1, 0, False, {}),
    "8x8 stride 3 offset 2": (8, 8, 3, 2, True, {}),
    "span cut": (8, 8, 1, 0, True, {"span_capacity": "inside"}),
    "dup cut": (8, 8, 1, 0, True, {"dup_capacity": "inside"}),
    "max_per_tile": (16, 64, 1, 0, True, {"max_per_tile": 128}),
    "8x8 SMEM_TILES": (8, 8, 1, 0, True, {}),
    "8x8 SMEM_TILES + 1": (8, 8, 1, 0, True, {}),
    "8x8 1024x768": (8, 8, 1, 0, True, {}),
}
# Images other than BIN_W x BIN_H: B3 counts whole tile ids in shared memory
# up to binning_cuda.SMEM_TILES tiles (12,032: 128x94 tiles) and in device
# memory past it (191x63 tiles: one more; 128x96).
BIN_IMAGE = {"8x8 SMEM_TILES": (1024, 752), "8x8 SMEM_TILES + 1": (1528, 504),
             "8x8 1024x768": (1024, 768)}


def _bin_case(name):
    from tinysplat_torch.ops import binning

    _need_card()
    th, tx, stride, offset, clip, caps_kw = BIN_CASES[name]
    width, height = BIN_IMAGE.get(name, (BIN_W, BIN_H))
    xys, depths, radii, valid, conics, opac = _bin_splats(len(name), BIN_N, width, height)
    geom = binning.BinGeometry(-(-width // tx), -(-height // th) // stride, th, tx, stride,
                               offset)
    extra = (conics, opac) if clip else (None, None)
    caps_kw = dict(caps_kw)
    roomy = binning.budgets(BIN_N, geom.tiles_x * geom.tiles_y, 128, 64 * BIN_N, 0,
                            32 * BIN_N)
    if caps_kw:
        rects = binning.splat_rects(xys, radii, valid, geom, *extra)
        order = binning.depth_order(depths, valid)
        _, span_len, _, _ = binning.expand_spans(rects, order, geom)
        lens = span_len.cpu().numpy()
        starts = np.cumsum(lens) - lens
        if caps_kw.get("span_capacity") == "inside":  # inside a splat's rows
            rows = rects.rows[order].cpu().numpy().astype(np.int64)
            deep = np.flatnonzero(rows >= 3)
            caps_kw["span_capacity"] = int((np.cumsum(rows) - rows)[deep[len(deep) // 2]] + 1)
        if caps_kw.get("dup_capacity") == "inside":  # a multiple of 128 inside a span
            caps_kw["dup_capacity"] = next(
                int(s + 128 - s % 128) for s, n in zip(starts, lens)
                if n >= 2 and s % 128 and s + 128 - s % 128 < s + n and s > lens.sum() // 2)
    caps = binning.budgets(BIN_N, geom.tiles_x * geom.tiles_y, 128,
                           caps_kw.get("dup_capacity", roomy.dup_capacity),
                           caps_kw.get("max_per_tile", 0),
                           caps_kw.get("span_capacity", roomy.span_capacity))
    return (xys, depths, radii, valid, geom, caps, 128, *extra)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BIN_CASES))
def test_binning_kernels_bit_equal_to_plain(name):
    from tinysplat_torch.ops import binning_cuda as bc

    args = _bin_case(name)
    rep = bc.stage_mismatch(*args)
    assert rep["ok"], rep
    if name.startswith("8x8 SMEM_TILES"):
        assert args[4].tiles_x * args[4].tiles_y == bc.SMEM_TILES + name.endswith("+ 1")
    c = rep["counters"]
    assert c["num_entries"] > 0
    if name in ("span cut", "dup cut"):
        assert c["dup_overflow"] > 0
    if name == "max_per_tile":
        assert c["tile_overflow"] > 0


@pytest.mark.cuda
# 12,032 and 12,033: binning_cuda.SMEM_TILES and one past it.
@pytest.mark.parametrize("num_tiles", [1 << 8, 12_032, 12_033, 1 << 16, (1 << 16) + 1])
def test_radix_sort_equals_stable_sort(num_tiles):
    from tinysplat_torch.ops import binning_cuda as bc

    _need_card()
    rng = np.random.default_rng(num_tiles)
    n, cap = 300_000, 300_032
    hot = rng.integers(0, num_tiles, 16)
    keys = np.where(rng.uniform(size=n) < 0.5, rng.choice(hot, n),
                    rng.integers(0, num_tiles, n))
    keys[-100:] = num_tiles - 1
    k = torch.zeros(cap, dtype=torch.int32, device="cuda")
    k[:n] = torch.as_tensor(keys, dtype=torch.int32, device="cuda")
    v = torch.arange(cap, dtype=torch.int32, device="cuda")
    counters = torch.tensor([n, n, 0], dtype=torch.int32, device="cuda")
    full = torch.zeros(num_tiles, dtype=torch.int32, device="cuda")
    out = torch.full((cap,), -1, dtype=torch.int32, device="cuda")
    before = _build.launches["radix_scatter"]
    bc.sort_by_tile(k.clone(), v.clone(), counters, num_tiles, full, out)
    assert _build.launches["radix_scatter"] - before == bc.radix_passes(num_tiles)
    want = torch.sort(k[:n], stable=True).indices.to(torch.int32)
    assert torch.equal(out[:n], want) and bool((out[n:] == -1).all())
    assert torch.equal(full, torch.bincount(k[:n].long(), minlength=num_tiles).int())


@pytest.mark.cuda
def test_tile_inputs_makes_no_host_sync():
    """tile_inputs on the card (binning through B1-B4, the table, the tile
    origins) queues without one host sync; the counters stay on the card."""
    _need_card()
    xys, depths, radii, valid, conics, opac = _bin_splats(3)
    colors = torch.rand((BIN_N, 4), device="cuda")
    kw = dict(tile_x=64, dup_capacity=64 * BIN_N, span_capacity=32 * BIN_N)
    ref = rc.tile_inputs(xys, depths, radii, conics, colors, opac, valid, BIN_H, BIN_W, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ti = rc.tile_inputs(xys, depths, radii, conics, colors, opac, valid, BIN_H, BIN_W, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ti.bins.num_entries.device.type == "cuda" and ti.bins.num_entries.dim() == 0
    for a, b in zip(ti.bins, ref.bins):
        assert torch.equal(a, b)
    assert torch.equal(ti.table.view(torch.int32), ref.table.view(torch.int32))  # NaN rows too


# SSIM's L1 and L2 (csrc/ssim.cu) against their plain versions: the bench
# frame's 1600x1066, one 11x11 window, an odd width, N = 3 and a band with its
# 10-row halo as the mesh step's interleaved mode stacks them. The map to
# ssim_cuda.TOL absolute; both images' gradients to TOL x their max |plain|,
# L2 alone (fed the plain partials) and L1's partials through L2 against the
# plain chain (the window sums run in another order: see TOL); two launches
# give the same bytes. The partials themselves are held through the
# gradient: dS/dmu is a difference of terms some ten times its size, so the
# moments' rounding shows there at ~1e-5 of its max in either version.
SSIM_SHAPES = {"1600x1066": (1, 1066, 1600), "11x11": (1, 11, 11), "odd width": (1, 29, 53),
               "N=3": (3, 24, 37), "band+halo": (4, 26, 48)}


def _ssim_pair(n, h, w, seed):
    """A uniform image and a noisy copy in [0, 1], on the card."""
    _need_card()
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()


def _scaled_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def _same_bytes(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SSIM_SHAPES))
def test_ssim_kernels_match_plain_and_repeat(name):
    n, h, w = SSIM_SHAPES[name]
    x, y = _ssim_pair(n, h, w, seed=h + w)
    window = sc.gaussian_window(11, 1.5)
    c1, c2 = 0.01**2, 0.03**2
    before = _build.launches["ssim_fwd"]
    smap, parts = sc.ssim_fwd(x, y, window, c1, c2, 4)
    again = sc.ssim_fwd(x, y, window, c1, c2, 4)
    only_map = sc.ssim_fwd(x, y, window, c1, c2)
    assert _build.launches["ssim_fwd"] == before + 3 and only_map[1] is None
    ref_map, ref_parts = sc.ssim_fwd_plain(x, y, window, c1, c2, 4)
    torch.cuda.synchronize()
    assert float((smap - ref_map).abs().max()) <= sc.TOL
    assert _same_bytes(smap, again[0]) and _same_bytes(parts, again[1])
    assert _same_bytes(smap, only_map[0])
    g = torch.from_numpy(np.random.default_rng(h).normal(size=tuple(smap.shape))
                         .astype(np.float32)).cuda()
    for mu, me, other in ((sc.MU_X, x, y), (sc.MU_Y, y, x)):
        args = (g, ref_parts[mu], ref_parts[sc.E_XX], ref_parts[sc.E_XY], me, other, window)
        before = _build.launches["ssim_bwd"]
        got, twice = sc.ssim_bwd(*args), sc.ssim_bwd(*args)
        chained = sc.ssim_bwd(g, parts[mu], parts[sc.E_XX], parts[sc.E_XY], me, other, window)
        assert _build.launches["ssim_bwd"] == before + 3
        ref = sc.ssim_bwd_plain(*args)
        torch.cuda.synchronize()
        assert _scaled_err(got, ref) <= sc.TOL, mu
        assert _scaled_err(chained, ref) <= sc.TOL, mu
        assert _same_bytes(got, twice)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mean broadcast", "strided"])
def test_ssim_bwd_reads_any_upstream_layout(kind):
    """The mean's gradient as a stride-0 broadcast (read in place) and a
    strided view (copied first) give the bytes of the same values laid out
    contiguously."""
    x, y = _ssim_pair(2, 40, 70, seed=7)
    window = sc.gaussian_window(11, 1.5)
    _, parts = sc.ssim_fwd(x, y, window, 1e-4, 9e-4, 3)
    shape = (2, 30, 60, 3)
    if kind == "mean broadcast":
        g = torch.full((), 1.0 / 10_800, device="cuda").expand(shape)
    else:
        g = torch.randn((2, 30, 120, 3), device="cuda")[:, :, ::2]
    args = (parts[sc.MU_X], parts[sc.E_XX], parts[sc.E_XY], x, y, window)
    assert _same_bytes(sc.ssim_bwd(g, *args), sc.ssim_bwd(g.contiguous(), *args))


@pytest.mark.cuda
def test_ssim_makes_no_host_sync():
    """SSIM forward and backward on the card queue without one host sync:
    the window goes by value, nothing is read back."""
    from tinysplat_torch.ops.ssim import ssim

    x, y = (t[0] for t in _ssim_pair(1, 64, 96, seed=3))
    x.requires_grad_()
    ssim(x, y).backward()  # the library is built and loaded
    torch.cuda.synchronize()
    x.grad = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        ssim(x, y).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.cuda
def test_a_trainer_step_runs_ssim_through_l1_and_l2():
    """One Trainer step on the card launches L1 once and L2 once (img1's
    gradient only: the ground truth needs none)."""
    _need_card()
    from tinysplat_torch.config import Config
    from tinysplat_torch.data.synthetic import synthetic_pcd
    from tinysplat_torch.models.gaussians import init_from_pcd
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    cams = orbit_cameras(2, width=128, height=96)
    rng = np.random.default_rng(4)
    for cam in cams:
        cam._image = rng.uniform(0, 1, (96, 128, 3)).astype(np.float32)
    pcd = synthetic_pcd(2000, seed=2)
    state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, device="cuda")
    tr = Trainer(Config(rasterizer="auto", sh_degree=1, warmup_densify=10**9,
                        interval_opacity_reset=0, prefetch_images=False, seed=5),
                 Scene(cams, seed=1), state)
    tr.train_step()
    fwd, bwd = _build.launches["ssim_fwd"], _build.launches["ssim_bwd"]
    tr.train_step()
    torch.cuda.synchronize()
    assert (_build.launches["ssim_fwd"] - fwd, _build.launches["ssim_bwd"] - bwd) == (1, 1)


@pytest.mark.cuda
def test_a_trainer_step_reduces_through_scatter_rows():
    """One Trainer step under "scatter" launches ``scatter_rows`` once, inside
    ``ts.composite.reduce``, and no ``index_add_`` there."""
    _need_card()
    from tinysplat_torch.config import Config
    from tinysplat_torch.data.synthetic import synthetic_pcd
    from tinysplat_torch.models.gaussians import init_from_pcd
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    cams = orbit_cameras(2, width=128, height=96)
    rng = np.random.default_rng(6)
    for cam in cams:
        cam._image = rng.uniform(0, 1, (96, 128, 3)).astype(np.float32)
    pcd = synthetic_pcd(2000, seed=3)
    state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, device="cuda")
    tr = Trainer(Config(rasterizer="auto", grad_reduce="scatter", sh_degree=1,
                        warmup_densify=10**9, interval_opacity_reset=0,
                        prefetch_images=False, seed=5), Scene(cams, seed=1), state)
    tr.train_step()
    torch.cuda.synchronize()
    before = _build.launches["scatter_rows"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.train_step()
        torch.cuda.synchronize()
    assert _build.launches["scatter_rows"] == before + 1

    def under_reduce(e):
        while e is not None:
            if e.name == "ts.composite.reduce":
                return True
            e = e.cpu_parent
        return False

    events = prof.events()
    assert any(e.name == "ts.composite.reduce" for e in events)
    inside = [e.name for e in events if under_reduce(e.cpu_parent)]
    assert inside.count("scatter_rows") == 1, inside
    assert not [name for name in inside if "index_add" in name], inside


# The served frame as one replayed CUDA graph (``frame_graph.FrameGraph``,
# through ``Trainer.render_camera``): each frame against the render that
# ``render_camera`` made before it, ``Camera.params`` and ``render`` run
# eagerly, bit for bit.
FRAME_W, FRAME_H = 1600, 1066
FRAME_KERNELS = {"splat_fwd_kernel": 1, "bin_count_kernel": 1, "bin_emit_kernel": 1,
                 "radix_hist_kernel": 2, "radix_scatter_kernel": 2, "composite_fwd_kernel": 1}


def _frame_trainer(n=200_000, views=5):
    """A ``Trainer`` on the card of ``n`` synthetic splats at SH degree 3 over
    ``views`` orbit views at FRAME_W x FRAME_H, 16x64 tiles."""
    _need_card()
    from tinysplat_torch.config import Config
    from tinysplat_torch.data.synthetic import synthetic_pcd
    from tinysplat_torch.models.gaussians import init_from_pcd
    from tinysplat_torch.scene import Scene
    from tinysplat_torch.train_loop import Trainer

    cams = orbit_cameras(views, width=FRAME_W, height=FRAME_H)
    pcd = synthetic_pcd(n, seed=7)
    state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=3, device="cuda")
    state.active_sh_degree.fill_(3)
    g = torch.Generator(device="cuda").manual_seed(1)
    state.params.colors_rest.data.copy_(
        0.1 * torch.randn(state.params.colors_rest.shape, device="cuda", generator=g))
    return Trainer(Config(rasterizer="auto", sh_degree=3, tile_x=64, prefetch_images=False,
                          seed=5), Scene(cams, seed=1), state)


def _eager_frame(tr, cam, background=None):
    """The frame as ``render_camera`` drew it before the frame graph."""
    from tinysplat_torch.render import render

    s, c = tr.state, tr.cfg
    bg = background if background is not None else torch.zeros(3, device="cuda")
    with torch.no_grad():
        return render(s.params, s.alive, cam.params("cuda"), cam.height, cam.width,
                      s.active_sh_degree, bg, rasterizer=c.rasterizer,
                      viewdirs_mode=c.viewdirs_mode, tile_size=c.tile_size,
                      dup_capacity=c.dup_capacity, max_per_tile=c.max_per_tile,
                      span_capacity=c.span_capacity, grad_reduce=c.grad_reduce,
                      tile_x=c.tile_x, antialiased=c.antialiased)


def _same_frame(a, b):
    (rgb_a, ex_a), (rgb_b, ex_b) = a, b
    assert torch.equal(rgb_a, rgb_b)
    for k in ("depth", "alpha", "radii", "xys", "depths"):
        assert torch.equal(ex_a[k], ex_b[k]), k
    for k in ex_b["binning"]:
        assert torch.equal(ex_a["binning"][k], ex_b["binning"][k]), k


@pytest.mark.cuda
def test_packed_camera_holds_camera_params_and_its_product():
    """One upload a frame: the packed camera's tensors equal ``Camera.params``'
    on the card, and its full projection equals the product that ``render``
    takes of them, bit for bit."""
    _need_card()
    import dataclasses

    from tinysplat_torch.frame_graph import FrameGraph

    for cam in orbit_cameras(5, width=FRAME_W, height=FRAME_H):
        packed, bg = FrameGraph()._upload(cam, None, None, torch.device("cuda"))
        ref = cam.params("cuda")
        for f in dataclasses.fields(ref):
            assert torch.equal(getattr(packed, f.name), getattr(ref, f.name)), f.name
        assert torch.equal(packed.full_projmat, ref.projmat @ ref.viewmat)
        assert torch.equal(bg, torch.zeros(3, device="cuda"))


@pytest.mark.cuda
def test_replayed_frames_equal_eager_frames_and_stay_the_callers():
    """Five poses, then five over a random background: the first frame runs
    eagerly, the second captures, the rest replay, each equal to the eager
    frame bit for bit, with the same launches counted and no host sync once
    captured; a frame the caller keeps is unchanged by the next one."""
    tr = _frame_trainer()
    cams = tr.scene.cameras
    _eager_frame(tr, cams[0])
    g = torch.Generator(device="cuda").manual_seed(2)
    kept, frames = [], 0
    for bg in (None, torch.rand(3, device="cuda", generator=g)):
        for cam in cams:
            before = _build.launches.copy()
            want = _eager_frame(tr, cam, bg)
            torch.cuda.synchronize()
            eager_counts = _build.launches - before
            before = _build.launches.copy()
            if frames >= 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = tr.render_camera(cam, background=bg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            assert _build.launches - before == eager_counts
            _same_frame(got, want)
            kept.append((got, tuple(t.clone() for t in (got[0], got[1]["depth"]))))
            frames += 1
    assert tr._frames.counts == {"eager": 1, "captures": 1, "replays": 9}
    assert dict(eager_counts) == {k[:-len("_kernel")]: v for k, v in FRAME_KERNELS.items()}
    for (rgb, extras), (rgb0, depth0) in kept:
        assert torch.equal(rgb, rgb0) and torch.equal(extras["depth"], depth0)


@pytest.mark.cuda
def test_frames_follow_the_state_in_place_and_replaced():
    """An in-place update (as Adam's) is read by the next replay; a replaced
    leaf is a new key: the next frame runs eagerly, the one after captures,
    and both follow the new state."""
    tr = _frame_trainer(views=2)
    cam = tr.scene.cameras[1]
    for _ in range(3):
        tr.render_camera(cam)
    old = tr.render_camera(cam)[0]
    with torch.no_grad():
        tr.state.params.colors_dc.add_(0.05)
    moved = tr.render_camera(cam)
    _same_frame(moved, _eager_frame(tr, cam))
    assert not torch.equal(moved[0], old)
    p = tr.state.params
    tr.state.params = type(p)(**{k: t.clone() for k, t in p.fields()})
    with torch.no_grad():
        tr.state.params.opacities.sub_(1.0)
    for _ in range(2):
        _same_frame(tr.render_camera(cam), _eager_frame(tr, cam))
    assert tr._frames.counts == {"eager": 2, "captures": 2, "replays": 5}


@pytest.mark.cuda
def test_graphed_frames_peak_within_one_percent_of_eager_frames():
    """``max_memory_allocated`` over graphed frames (the eager first frame,
    the capture, replays) is within 1% of the eager frames'."""
    tr = _frame_trainer(n=262_144)
    cams = tr.scene.cameras
    _eager_frame(tr, cams[0])
    torch.cuda.synchronize()
    peaks = []
    for graphed in (False, True):
        torch.cuda.reset_peak_memory_stats()
        for cam in cams * 2:
            frame = tr.render_camera(cam) if graphed else _eager_frame(tr, cam)
            del frame
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    assert tr._frames.counts["replays"] == 9
    assert abs(peaks[1] - peaks[0]) <= 0.01 * peaks[0], peaks


@pytest.mark.cuda
def test_replayed_kernels_are_traced_under_their_names():
    """A profiler started after the capture sees each replayed kernel of the
    frame by name, as the benchmark's rooflines find them. The frames start
    50 ms into the window: the profiler drops a device event stamped before
    its window opened, and the card's clock runs up to ~150 us off the
    host's, so a kernel launched at once could fall out of the window."""
    import re
    import time

    tr = _frame_trainer(n=50_000, views=2)
    cam = tr.scene.cameras[0]
    for _ in range(3):
        tr.render_camera(cam)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.05)
        for _ in range(2):
            tr.render_camera(cam)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda and not e.is_user_annotation()]
    got = {k: sum(1 for n in names if re.search(r"(?<![A-Za-z0-9_])" + k + r"(?![A-Za-z0-9_])",
                                                n)) for k in FRAME_KERNELS}
    assert got == {k: 2 * v for k, v in FRAME_KERNELS.items()}, (got, sorted(set(names)))
    assert tr._frames.counts["replays"] == 4
