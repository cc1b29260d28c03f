"""S2's launch geometry (``splat_inputs_cuda.bwd_geometry``), on the CPU.

The kernel (``csrc/splat_bwd.cu``) refuses a launch whose geometry is not
its own, so these checks hold the numbers the wrapper passes: every splat
in one block, every block's camera partials summed by exactly one fold
thread, and a shared-memory span an H100 block can hold.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from tinysplat_torch.ops import splat_inputs_cuda as si

from tests._torch_threads import one_torch_thread  # noqa: F401

SOURCE = Path(si.__file__).resolve().parent.parent / "csrc" / "splat_bwd.cu"
KS = (1, 4, 9, 16, 25)
NS = (0, 1, 127, 128, 129, 524_288, 1_048_576)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_bwd_geometry_covers_every_splat_and_block_once(n, k):
    geo = si.bwd_geometry(n, k)
    # one thread a splat: the blocks hold every splat, and no block is empty
    assert geo.blocks * si.BWD_BLOCK >= n
    assert geo.blocks == 0 or (geo.blocks - 1) * si.BWD_BLOCK < n
    # fold thread t sums partial rows [t run, (t + 1) run): each row once
    hits = np.zeros(geo.blocks, np.int64)
    for t in range(si.FOLD_THREADS):
        hits[min(t * geo.fold_run, geo.blocks):min((t + 1) * geo.fold_run, geo.blocks)] += 1
    assert (hits == 1).all()
    assert geo.fold_run * si.FOLD_THREADS < geo.blocks + si.FOLD_THREADS
    # the span of a full block, at any offset from a 16-byte boundary: within
    # the 227 KB an H100 block may ask for, and the 48 KB it gets unasked
    assert geo.smem_bytes <= 48 * 1024 < 232_448
    if k == 1:
        assert geo.smem_bytes == 0
    else:
        assert geo.smem_bytes >= si.BWD_BLOCK * (k - 1) * 3 * 4 + 12
        assert geo.smem_bytes % 16 == 0
    # the camera partials: one float64 a block and column, written and read
    plain, with_cam = si.layer_bytes(n, k)[1], si.layer_bytes(n, k, cam_grad=True)[1]
    assert with_cam - plain == geo.blocks * si.CAM_COLS * 8 * 2


def test_bwd_geometry_follows_the_kernel_source():
    text = SOURCE.read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert consts["kBwdBlock"] == si.BWD_BLOCK
    assert consts["kFoldThreads"] == si.FOLD_THREADS
    assert "k > 1 ? kBwdBlock * (k - 1) * 3 * 4 + 16 : 0" in text


def test_layer_bytes_count_the_work_not_the_launch():
    # 516 bytes a splat at K = 16: each input read once, each gradient written once
    n = 524_288
    assert si.layer_bytes(n, 16)[1] == 516 * n == 270_532_608
    assert si.layer_bytes(n, 16, cam_grad=True)[1] == 516 * n + (n // 128) * 31 * 16
