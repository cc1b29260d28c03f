"""The port's CUDA kernels against their plain PyTorch versions, on the card.

JAX-free, so that it runs where only the port and CUDA torch are
installed: ``python -m pytest tests/test_torch_port_cuda.py`` on a GPU.
Every test is marked ``cuda`` and skips where torch sees no CUDA device.

Tolerances: K2's per-entry rows to 1e-5 x the column's max |plain| (the
masks are K1's bit for bit; only the order of the pixel sums differs); K3
bit for bit (it adds each run in the plain version's order). The probes:
P1 bit for bit (it moves bits as integers); P2 per row, as
``op_costs.TOLERANCE`` states with its reasons.
"""
import numpy as np
import pytest
import torch

from tinysplat_torch.ops import rasterize_cuda as rc
from tinysplat_torch.probes import bitcast, op_costs


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")


def _case(n, height, width, tile_x, seed):
    """Compositing inputs for n random screen-space splats on the card."""
    _need_card()
    rng = np.random.default_rng(seed)
    xys = rng.uniform((-6, -6), (width + 6, height + 6), size=(n, 2))
    L = rng.normal(size=(n, 2, 2)) * 2.0
    cov = L @ np.swapaxes(L, 1, 2) + np.eye(2)
    inv = np.linalg.inv(cov)
    radii = np.ceil(3.5 * np.sqrt(np.linalg.eigvalsh(cov).max(axis=1)))

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    ti = rc.tile_inputs(
        cuda(xys), cuda(rng.uniform(0.5, 5.0, n)), cuda(radii, torch.int32),
        cuda(np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], axis=1)),
        cuda(rng.uniform(0, 1, (n, 4))), cuda(rng.uniform(0.05, 1.0, n)),
        cuda(rng.uniform(size=n) > 0.05, torch.bool), height, width, tile_x=tile_x)
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    out = rc.composite_fwd(*args, tile_x)
    gout = torch.zeros_like(out)
    gout[:, 0:5] = cuda(rng.normal(size=tuple(out[:, 0:5].shape)))
    return ti, args, out, gout


@pytest.mark.cuda
@pytest.mark.parametrize("tile_x", [16, 64])
def test_k2_matches_plain(tile_x):
    ti, args, out, gout = _case(600, 64, 128, tile_x, seed=tile_x)
    before = rc.composite_bwd.launches
    got = rc.composite_bwd(*args, out, gout, tile_x)
    assert rc.composite_bwd.launches == before + 1
    ref = rc.composite_bwd_plain(*args, out, gout, tile_x)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    assert float(((got - ref).abs() / scale).max()) <= 1e-5
    assert (ref.abs().amax(dim=1) > 0).sum() > 100  # a live prefix was compared


@pytest.mark.cuda
def test_k3_matches_plain_and_every_reduction_agrees():
    ti, args, out, gout = _case(600, 64, 128, 64, seed=3)
    rows = rc.composite_bwd(*args, out, gout, 64)
    n = ti.table.shape[0] - 1
    gs, bounds = rc.segsum_inputs(rows, ti.entry_rank, n)
    before = rc.segsum.launches
    got = rc.segsum(gs, bounds)
    assert rc.segsum.launches == before + 1
    assert torch.equal(got, rc.segsum_plain(gs, bounds))
    ref = rc.reduce_entry_grads(rows, ti.entry_rank, n, "scatter")
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    for strategy in rc.GRAD_REDUCE:
        red = rc.reduce_entry_grads(rows, ti.entry_rank, n, strategy)
        assert float(((red - ref).abs() / scale).max()) <= 1e-5, strategy


@pytest.mark.cuda
@pytest.mark.parametrize("variant", bitcast.VARIANTS)
def test_p1_bitcast_exact_and_equal_to_plain(variant):
    _need_card()
    gt = bitcast.ground_truth()
    x = bitcast.variant_input(variant, gt, "cuda")
    before = bitcast.probe_bitcast.launches
    got = bitcast.probe_bitcast(variant, x)
    assert bitcast.probe_bitcast.launches == before + 1
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
    before = op_costs.probe_op_costs.launches
    got = op_costs.probe_op_costs(op, x)
    assert op_costs.probe_op_costs.launches == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = op_costs.TOLERANCE.get(op, 0.0)
    assert op_costs.rel_err(got, op_costs.probe_op_costs_plain(op, x)) <= tol
    if op in op_costs.TRI:  # after one pass, before the values underflow
        one = op_costs.probe_op_costs(op, x, 1)
        assert float(one.abs().max()) > 0.1
        assert op_costs.rel_err(one, op_costs.probe_op_costs_plain(op, x, 1)) <= tol
