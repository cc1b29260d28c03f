"""Port compositing backward (K2's plain version through ``rasterize_cuda``
on CPU tensors) and the gradient reductions vs the JAX package.

Tolerances: gradients to 2e-4 x the field's max |gradient| against
``jax.grad`` of the dense oracle and of the Pallas kernels (interpret mode,
as test_rasterize_pallas.py runs them), 5e-4 x max in the heavy-occlusion
case (the stop at T <= 1e-4 decides there); per-entry rows to 1e-4 x the
column's max against the Pallas backward kernel (its log-space cumulative
product rebuilds T to ~1e-6). The CUDA kernels themselves are held against
the plain versions on the card (``chip_smoke.py`` and the JAX-free
``test_torch_port_cuda.py``).
"""
import collections
import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.ops import rasterize_pallas as rp
from tinysplat_tpu.ops.rasterize_dense import rasterize_dense as jax_dense
from tinysplat_tpu.ops.rasterize_pallas import rasterize_pallas

from tinysplat_torch.ops import _build
from tinysplat_torch.ops import rasterize_cuda as rc

from test_rasterize_tiled import random_case, to_jnp
from test_torch_port_rasterize import _torch_args

from tests._torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("xys", "conics", "colors", "opac")


def _target(H, W, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 4)).astype(np.float32)


def _grad_case():
    return random_case(n=80, H=32, W=48, seed=2)


@functools.cache
def _jax_grads(backend, grad_reduce="scatter"):
    """jax.grad of mean((img - target)^2) w.r.t. (xys, conics, colors,
    opacities) through the JAX dense oracle or Pallas kernels."""
    xys, depths, radii, conics, colors, opac, valid, H, W, bg = to_jnp(_grad_case())
    tgt = jnp.asarray(_target(H, W))

    def loss(xys, conics, colors, opac):
        if backend == "dense":
            img, _ = jax_dense(xys, depths, conics, colors, opac, valid, H, W, bg)
        else:
            img, _ = rasterize_pallas(xys, depths, radii, conics, colors, opac, valid,
                                      H, W, bg, chunk=16, grad_reduce=grad_reduce)
        return jnp.mean((img - tgt) ** 2)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(xys, conics, colors, opac)
    return [np.asarray(g) for g in grads]


def _port_grads(case, loss_fn, **kw):
    xys, depths, radii, conics, colors, opac, valid, H, W, bg = _torch_args(case)
    leaves = [x.clone().requires_grad_() for x in (xys, conics, colors, opac)]
    img, _ = rc.rasterize_cuda(leaves[0], depths, radii, leaves[1], leaves[2], leaves[3],
                               valid, H, W, bg, **kw)
    loss_fn(img).backward()
    return [x.grad.numpy() for x in leaves]


def _assert_grads_close(got, ref, rel):
    for g, r, name in zip(got, ref, FIELDS):
        scale = max(float(np.abs(r).max()), 1e-8)
        np.testing.assert_allclose(g, r, atol=rel * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("grad_reduce", rc.GRAD_REDUCE)
def test_plain_backward_matches_jax(grad_reduce):
    case = _grad_case()
    tgt = torch.from_numpy(_target(case[7], case[8]))
    got = _port_grads(case, lambda img: torch.mean((img - tgt) ** 2), chunk=16,
                      grad_reduce=grad_reduce)
    _assert_grads_close(got, _jax_grads("dense"), 2e-4)
    _assert_grads_close(got, _jax_grads("pallas", grad_reduce), 2e-4)


def test_plain_backward_heavy_occlusion_matches_dense():
    """Near-opaque stacks: T saturates and the sticky stop decides."""
    n, H, W = 48, 16, 16
    rng = np.random.default_rng(3)
    case = (rng.uniform(2, 14, size=(n, 2)).astype(np.float32),
            rng.uniform(0.5, 5.0, size=(n,)).astype(np.float32),
            np.full(n, 14, np.int32),
            np.tile(np.asarray([[0.15, 0.0, 0.15]], np.float32), (n, 1)),
            rng.uniform(0, 1, size=(n, 4)).astype(np.float32),
            rng.uniform(0.9, 1.0, size=(n,)).astype(np.float32),
            np.ones(n, bool), H, W, np.asarray([0.3, 0.1, 0.2, 0.5], np.float32))
    xys, depths, _, conics, colors, opac, valid, _, _, bg = to_jnp(case)

    def loss(xys, conics, colors, opac):
        img, _ = jax_dense(xys, depths, conics, colors, opac, valid, H, W, bg)
        return jnp.sum(img ** 2)

    ref = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(xys, conics, colors,
                                                                       opac)]
    got = _port_grads(case, lambda img: torch.sum(img ** 2), chunk=8, tile_x=16)
    _assert_grads_close(got, ref, 5e-4)


def test_composite_bwd_plain_matches_pallas_rows():
    """Per-entry gradient rows vs the Pallas backward kernel's, for one
    numpy-drawn cotangent of the compositing output."""
    case = random_case(n=100, H=40, W=56, seed=0)
    chunk, tile_x = 32, 16
    xys, depths, radii, conics, colors, opac, valid, H, W, _ = to_jnp(case)
    n = xys.shape[0]
    tiles_x, tiles_y = -(-W // tile_x), -(-H // 16)
    num_tiles = tiles_x * tiles_y
    bins = rp.bin_splats_dense(xys, depths, radii, valid, tiles_x, tiles_y, 16, chunk=chunk,
                               conics=conics, opacities=opac, tile_size_x=tile_x)
    per_splat = jnp.concatenate(
        [xys, conics, opac.reshape(-1, 1), colors, jnp.zeros((n, 6))], axis=1)
    table = jnp.concatenate([per_splat[bins.order], jnp.zeros((1, 16))])
    attr_rows = table[jnp.where(bins.entry_rank < 0, n, bins.entry_rank)]
    tid = jnp.arange(num_tiles, dtype=jnp.int32)
    sx, sy = (tid % tiles_x) * tile_x, (tid // tiles_x) * 16
    tpb = min(8, num_tiles)
    fns = rp._cached_pallas_fns(num_tiles, bins.entry_rank.shape[0], chunk, tpb, tile_x)
    out_j, vjp = jax.vjp(lambda rows: fns(rows, bins.tile_starts, bins.counts, sx, sy),
                         attr_rows)
    gout = np.zeros(out_j.shape, np.float32)
    gout[:num_tiles, 0:5] = np.random.default_rng(9).normal(
        size=(num_tiles, 5, 16 * tile_x)).astype(np.float32)
    (ref,) = vjp(jnp.asarray(gout))
    ref = np.asarray(ref)[:, :rc.TABLE_COLS]

    ti = rc.tile_inputs(*_torch_args(case)[:9], chunk=chunk, tile_x=tile_x)
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    out = rc.composite_fwd(*args, tile_x)
    got = rc.composite_bwd(*args, out, torch.from_numpy(gout[:num_tiles]), tile_x).numpy()
    assert got.shape == ref.shape
    live = np.abs(ref).max(axis=1) > 0
    assert live.sum() > 100  # the case has a live prefix to compare
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-8)
    ratio = np.abs(got - ref) / scale
    assert ratio.max() <= 1e-4, ratio.max(axis=0)


def _brute_counts(ti, out, tile_x, tile_h=16):
    """composite_counts' pair and warp counts, one tile, entry and pixel at
    a time in numpy float32, from K1's output rows, the same alpha
    arithmetic and each row's box (entry_extent); warps as K1 and K2 run
    them: 8 x 4 patches of 16 x 16 sub-tiles, those past a ragged tile's
    edge left out."""
    table, ranks = ti.table.numpy(), ti.entry_rank.numpy()
    extent = rc.entry_extent(ti.table).numpy()
    starts, counts = ti.tile_starts.numpy(), ti.counts.numpy()
    sentinel, p = table.shape[0] - 1, tile_h * tile_x
    pix = np.arange(p)
    lx, ly = pix % tile_x, pix // tile_x
    wid = (ly // 4) * -(-tile_x // 8) + lx // 8
    sub = (ly // 16) * -(-tile_x // 16) + lx // 16
    subs = [(sub == s, len(np.unique(wid[sub == s]))) for s in range(sub.max() + 1)]
    got = dict.fromkeys(["k1", "k1_box", "k2_pixel", "k2_box", "k2_sub", "kept", "walked",
                         "kept warps", "kept outside the box"], 0)
    out = out.numpy()
    for t in range(starts.shape[0]):
        n_contrib, cnt = out[t, 5].astype(int), int(counts[t])
        k1 = np.minimum(n_contrib + 1, cnt)
        own = np.minimum(out[t, 6].astype(int), cnt)
        sub_live = [int(own[in_sub].max()) for in_sub, _ in subs]
        got["k1"] += int(k1.sum())
        got["k2_pixel"] += int(own.sum())
        got["k2_sub"] += sum(n * int(in_sub.sum()) for n, (in_sub, _) in zip(sub_live, subs))
        got["walked"] += sum(n * warps for n, (_, warps) in zip(sub_live, subs))
        px = (ti.sx[t].item() + lx).astype(np.float32)
        py = (ti.sy[t].item() + ly).astype(np.float32)
        for e in range(int(k1.max())):
            r = int(ranks[starts[t] + e])
            r = sentinel if r < 0 or r > sentinel else r
            x, y, a, b, c, op = table[r, :6]
            dx, dy = px - x, py - y
            sigma = np.float32(0.5) * (a * dx * dx + c * dy * dy) + b * dx * dy
            alpha = np.minimum(op * np.exp(-sigma), np.float32(0.999))
            kept = (e < n_contrib) & (sigma >= 0) & (alpha >= np.float32(1.0 / 255.0))
            inside = (np.abs(dx) <= extent[r, 0]) & (np.abs(dy) <= extent[r, 1])
            got["k1_box"] += int((inside & (e < k1)).sum())
            got["k2_box"] += int((inside & (e < own)).sum())
            got["kept"] += int(kept.sum())
            got["kept warps"] += len(np.unique(wid[kept]))
            got["kept outside the box"] += int((kept & ~inside).sum())
    return got


@pytest.mark.parametrize("tile_x", [16, 64])
def test_composite_counts_match_brute_force(tile_x):
    case = random_case(n=160, H=40, W=72, seed=11)
    ti = rc.tile_inputs(*_torch_args(case)[:9], tile_x=tile_x)
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    out = rc.composite_fwd(*args, tile_x)
    counts = rc.composite_counts(*args, out, tile_x)
    ref = _brute_counts(ti, out, tile_x)
    for name in ("k1", "k1_box", "k2_pixel", "k2_box", "k2_sub", "kept"):
        assert counts["pairs"][name] == ref[name], name
    assert counts["warps"] == {"walked": ref["walked"], "kept": ref["kept warps"]}
    # The box is sound (no kept pair outside it) and culls.
    assert ref["kept outside the box"] == 0
    assert 0 < ref["kept"] < ref["k2_box"] < ref["k2_pixel"] <= ref["k2_sub"]
    assert ref["k2_box"] <= ref["k1_box"] < ref["k1"]
    live = torch.minimum(out[:, 6].amax(dim=1), ti.counts.float())
    assert counts["tile_entries"]["k2"]["max"] == float(live.max())
    assert counts["sub_entries"]["k2"]["max"] == float(live.max())
    assert counts["sub_entries"]["k2"]["mean"] <= counts["tile_entries"]["k2"]["mean"]


def test_entry_extent_boxes():
    """The box's edge cases: no pixel passes below 1/255 or at a NaN
    opacity (-inf), no bound for a conic that is not positive definite or is
    too thin (+inf); a round splat's box holds its alpha support."""
    inf = float("inf")
    rows = torch.zeros((6, rc.TABLE_COLS))
    rows[:, 2:6] = torch.tensor([
        [0.5, 0.0, 0.5, 1.0],  # round: sigma = r^2 / 4
        [0.5, 0.0, 0.5, 0.003],  # below 1/255
        [0.5, 0.0, 0.5, float("nan")],
        [0.5, 0.6, 0.5, 1.0],  # det < 0
        [1e3, 0.0, 1e-3, 1.0],  # condition number 1e6
        [0.0, 0.0, 0.0, 0.0],  # the sentinel row
    ])
    ext = rc.entry_extent(rows)
    assert ext.dtype == torch.float32
    # alpha >= 1/255 needs r^2 / 4 <= ln 255, r <= 4.71; the box adds margins.
    assert 4.71 < float(ext[0, 0]) == float(ext[0, 1]) < 6.0
    for i, want in ((1, -inf), (2, -inf), (3, inf), (4, inf), (5, -inf)):
        assert ext[i].tolist() == [want, want], i


def _random_rows(d=400, n=60, seed=0):
    rng = np.random.default_rng(seed)
    ranks = rng.integers(-1, n, size=d).astype(np.int32)  # -1 = pad slot
    ranks[rng.uniform(size=d) < 0.1] = n + 3  # out of range: also goes nowhere
    rows = rng.normal(size=(d, rc.TABLE_COLS)).astype(np.float32)
    ref = np.zeros((n, rc.TABLE_COLS), np.float64)
    ok = (ranks >= 0) & (ranks < n)
    np.add.at(ref, ranks[ok], rows[ok].astype(np.float64))
    return torch.from_numpy(rows), torch.from_numpy(ranks), ref


@pytest.mark.parametrize("grad_reduce", rc.GRAD_REDUCE)
def test_reduce_entry_grads_sums_each_splat(grad_reduce):
    rows, ranks, ref = _random_rows()
    got = rc.reduce_entry_grads(rows, ranks, ref.shape[0], grad_reduce)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("grad_reduce", rc.GRAD_REDUCE)
def test_table_grad_is_the_per_splat_rows_and_a_zero_row(grad_reduce):
    """The one choice of strategy: the backward's table gradient is
    ``reduce_entry_grads``' rows with the sentinel row, exactly 0, below."""
    rows, ranks, ref = _random_rows(seed=7)
    n = ref.shape[0]
    got = rc.table_grad(rows, ranks, n, grad_reduce)
    assert got.shape == (n + 1, rc.TABLE_COLS) and got.dtype == torch.float32
    assert torch.equal(got[:n], rc.reduce_entry_grads(rows, ranks, n, grad_reduce))
    assert (got[n].view(torch.int32) == 0).all()
    np.testing.assert_allclose(got[:n].numpy(), ref, atol=1e-5, rtol=0)


def _todays_scatter(rows, ranks, n):
    """The "scatter" table gradient as the backward made it before
    ``scatter_rows``: ``index_add_`` into n + 1 rows, the pads' sink row n
    dropped, a zero sentinel row appended."""
    ids = rc._splat_ids(ranks, n)
    return torch.cat([rows.new_zeros((n + 1, rc.TABLE_COLS)).index_add_(0, ids, rows)[:n],
                      rows.new_zeros((1, rc.TABLE_COLS))])


def _only_pads(d=300, n=40):
    ranks = np.where(np.arange(d) % 3 == 0, -1, n + np.arange(d) % 5).astype(np.int32)
    return _spread_rows(d, 11), torch.from_numpy(ranks), n


# name -> (rows, entry_rank, n) for scatter_rows.
SCATTER_CASES = {
    "pads and out-of-range ranks": lambda: _random_rows()[:2] + (60,),
    "rows of 1e-3..1e3": lambda: (_spread_rows(1000, 12), _random_rows(d=1000, seed=3)[1],
                                  60),
    "E = 0": _only_pads,
    "n = 0": lambda: _random_rows(d=50, n=7)[:2] + (0,),
    "D = 0": lambda: (torch.zeros((0, rc.TABLE_COLS)), torch.zeros(0, dtype=torch.int32), 9),
}


@pytest.mark.parametrize("name", list(SCATTER_CASES))
def test_scatter_rows_plain_is_todays_index_add(name):
    """On CPU tensors ``scatter_rows`` launches nothing and gives the bytes of
    the ``index_add_`` expression it replaced, the sentinel row exactly 0."""
    rows, ranks, n = SCATTER_CASES[name]()
    before = _build.launches["scatter_rows"]
    got = rc.scatter_rows(rows, ranks, n)
    assert _build.launches["scatter_rows"] == before
    ref = _todays_scatter(rows, ranks, n)
    assert got.shape == (n + 1, rc.TABLE_COLS) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert (got[n].view(torch.int32) == 0).all()
    assert torch.equal(rc.reduce_entry_grads(rows, ranks, n, "scatter"), got[:n])


def test_scatter_backward_gives_todays_table_gradient():
    """The compositing backward under "scatter" hands autograd
    ``scatter_rows``' rows whole: the bytes of K2's rows reduced and
    concatenated with a zero row as before."""
    case = random_case(n=60, H=32, W=48, seed=4)
    ti = rc.tile_inputs(*_torch_args(case)[:9], tile_x=16)
    table = ti.table.clone().requires_grad_()
    args = (ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    out = rc.composite_tiles(table, *args, 16, "scatter")
    gout = torch.from_numpy(np.random.default_rng(5).normal(size=tuple(out.shape))
                            .astype(np.float32))
    out.backward(gout)
    rows = rc.composite_bwd(ti.table, *args, out.detach(), gout, 16)
    ref = _todays_scatter(rows, ti.entry_rank, ti.table.shape[0] - 1)
    assert torch.equal(table.grad.view(torch.int32), ref.view(torch.int32))
    assert bool((ref[:-1] != 0).any())


# name -> (arguments from good (8, 10) rows and 8 ranks, error, message).
SCATTER_REJECTS = {
    "float64 rows": (lambda r, k: (r.double(), k, 4), TypeError, "rows must be float32"),
    "9 columns": (lambda r, k: (r[:, :9], k, 4), TypeError, "rows must be float32"),
    "1-D rows": (lambda r, k: (r.reshape(-1), k, 4), TypeError, "rows must be float32"),
    "int64 ranks": (lambda r, k: (r, k.long(), 4), TypeError, "entry_rank must be"),
    "2-D ranks": (lambda r, k: (r, k[:, None], 4), TypeError, "entry_rank must be"),
    "7 ranks for 8 rows": (lambda r, k: (r, k[:7], 4), ValueError, "entry_rank has 7"),
    "negative n": (lambda r, k: (r, k, -1), ValueError, "n must lie"),
    "ranks on another device": (lambda r, k: (r, k.to("meta"), 4), ValueError,
                                "entry_rank is on meta"),
    "meta tensors": (lambda r, k: (r.to("meta"), k.to("meta"), 4), ValueError,
                     "CUDA or CPU tensors, not meta"),
}


@pytest.mark.parametrize("name", list(SCATTER_REJECTS))
def test_scatter_rows_rejects(name):
    make, error, message = SCATTER_REJECTS[name]
    rows, ranks = torch.zeros((8, rc.TABLE_COLS)), torch.zeros(8, dtype=torch.int32)
    with pytest.raises(error, match=message):
        rc.scatter_rows(*make(rows, ranks))


def test_segsum_plain_sums_runs_in_order():
    rows, _, _ = _random_rows(d=50)
    perm = torch.from_numpy(np.random.default_rng(4).permutation(50).astype(np.int32))

    def in_order(lo, hi):  # the kernel's order: one row at a time, through perm
        acc = torch.zeros(rc.TABLE_COLS)
        for p in range(lo, hi):
            acc = acc + rows[int(perm[p])]
        return acc

    before = _build.launches["segsum"]
    bounds = torch.tensor([0, 0, 3, 3, 10, 49, 50, 50], dtype=torch.int32)
    got = rc.segsum(rows, perm, bounds)
    assert _build.launches["segsum"] == before  # CPU tensors never reach the kernel
    for i in range(bounds.shape[0] - 1):
        assert torch.equal(got[i], in_order(int(bounds[i]), int(bounds[i + 1]))), i
    # Bounds past the rows are clamped, never read out of range.
    clamped = rc.segsum(rows, perm, torch.tensor([45, 60, 80], dtype=torch.int32))
    assert torch.equal(clamped[0], in_order(45, 50))
    assert (clamped[1] == 0).all()


def test_launch_counts_each_accepted_launch_by_symbol(monkeypatch):
    """``_build.launch`` counts one launch in ``_build.launches`` under the
    entry point's symbol (the source's name when none is given) once the
    entry point returns 0; a refused launch raises and counts nothing; and
    ``scatter_rows`` and ``segsum`` on CPU tensors never reach it."""
    calls, errors = [], {}

    def fake_function(name, symbol, argtypes):
        def entry_point(*args):
            calls.append((name, symbol, args))
            return errors.get(symbol, 0)
        return entry_point

    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "launches", collections.Counter())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=77))
    _build.launch("segsum", (), "cuda:0", 1, 2)
    _build.launch("segsum", (), "cuda:0")
    _build.launch("binning", (), "cuda:0", symbol="bin_emit")
    assert dict(_build.launches) == {"segsum": 2, "bin_emit": 1}
    assert calls == [("segsum", "segsum", (1, 2, 77)), ("segsum", "segsum", (77,)),
                     ("binning", "bin_emit", (77,))]

    errors["radix_hist"] = 700
    with pytest.raises(RuntimeError, match="radix_hist kernel launch failed: CUDA error 700"):
        _build.launch("binning", (), "cuda:0", symbol="radix_hist")
    assert len(calls) == 4 and dict(_build.launches) == {"segsum": 2, "bin_emit": 1}

    rows, ranks, _ = _random_rows(d=50)
    rc.scatter_rows(rows, ranks, 60)
    rc.segsum(rows, torch.arange(50, dtype=torch.int32),
              torch.tensor([0, 10, 50], dtype=torch.int32))
    assert len(calls) == 4 and dict(_build.launches) == {"segsum": 2, "bin_emit": 1}


def _gathered_segsum(gs, bounds):
    """The segment loop over a gathered copy gs = rows[perm] (K3's plain
    version before the kernel took the gather in)."""
    n_rows = gs.shape[0]
    b = bounds.long().clamp(0, n_rows)
    lo = b[:-1]
    length = torch.maximum(b[1:], lo) - lo
    acc = gs.new_zeros((lo.shape[0], rc.TABLE_COLS))
    for k in range(int(length.max()) if n_rows and lo.numel() else 0):
        ok = (k < length)[:, None]
        acc = torch.where(ok, acc + gs[torch.clamp(lo + k, max=n_rows - 1)], acc)
    return acc


def _spread_rows(d, seed):
    """(d, 10) float32 rows of magnitudes 1e-3..1e3, so the order of the adds
    shows in the low bits."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(d, rc.TABLE_COLS)) * 10.0 ** rng.uniform(-3, 3, (d, 1))
    return torch.from_numpy(rows.astype(np.float32))


def test_segsum_plain_equals_the_gathered_loop():
    """Empty runs, runs of 100+ rows, bounds below 0 and past D: bit for
    bit the loop over rows[perm]."""
    d = 400
    rows = _spread_rows(d, 5)
    perm = torch.from_numpy(np.random.default_rng(6).permutation(d).astype(np.int32))
    bounds = torch.tensor([-7, 0, 0, 1, 130, 130, 131, 260, 399, 400, 450, 450, 600],
                          dtype=torch.int32)
    got = rc.segsum_plain(rows, perm, bounds)
    ref = _gathered_segsum(rows[perm.long()], bounds)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert (got[[0, 1, 4, 9, 10, 11]] == 0).all()  # the empty and clamped runs
    assert (got[[3, 6]] != 0).all()  # the runs of 129 rows


def test_segsum_inputs_int32_sort_matches_int64():
    """The int32 sort gives the permutation and bounds of a stable int64
    sort, and "mxu" per-splat rows equal the gathered loop's bit for bit."""
    d, n = 3000, 200
    rng = np.random.default_rng(8)
    ranks = rng.integers(-1, n, size=d).astype(np.int32)
    ranks[rng.uniform(size=d) < 0.1] = n + 5
    ranks[:150] = 17  # one splat with a run of 150+ rows
    ranks_t = torch.from_numpy(ranks)
    perm, bounds = rc.segsum_inputs(ranks_t, n)
    assert perm.dtype == bounds.dtype == torch.int32
    ids64 = ranks_t.long()
    ids64 = torch.where((ids64 < 0) | (ids64 >= n), n, ids64)
    sorted64, perm64 = torch.sort(ids64, stable=True)
    bounds64 = torch.searchsorted(sorted64, torch.arange(n + 1))
    assert torch.equal(perm.long(), perm64)
    assert torch.equal(bounds.long(), bounds64)
    rows = _spread_rows(d, 9)
    got = rc.reduce_entry_grads(rows, ranks_t, n, "mxu")
    ref = _gathered_segsum(rows[perm64], bounds64.to(torch.int32))
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_backward_argument_checks():
    case = random_case(n=20, H=16, W=16, seed=1)
    ti = rc.tile_inputs(*_torch_args(case)[:9])
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    out = rc.composite_fwd(*args, ti.tile_x)
    with pytest.raises(ValueError, match="gout"):
        rc.composite_bwd(*args, out, out[:, :5], ti.tile_x)
    with pytest.raises(ValueError, match="out"):
        rc.composite_bwd(*args, out.double(), out, ti.tile_x)
    with pytest.raises(TypeError):
        rc.composite_bwd(ti.table, ti.entry_rank.long(), *args[2:], out, out, ti.tile_x)
    rows = torch.zeros((8, rc.TABLE_COLS))
    perm, bounds = torch.arange(8, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        rc.segsum(rows.double(), perm, bounds)
    with pytest.raises(TypeError):
        rc.segsum(rows, perm, bounds.long())
    with pytest.raises(TypeError, match="perm"):
        rc.segsum(rows, perm.long(), bounds)
    with pytest.raises(ValueError, match="perm has 7 entries"):
        rc.segsum(rows, perm[:7], bounds)
    with pytest.raises(ValueError, match="perm is on meta"):
        rc.segsum(rows, perm.to("meta"), bounds)
    with pytest.raises(ValueError, match="grad_reduce"):
        rc.reduce_entry_grads(rows, torch.zeros(8, dtype=torch.int32), 4, "atomic")
    with pytest.raises(ValueError, match="grad_reduce"):
        rc.rasterize_cuda(*_torch_args(case), grad_reduce="atomic")
