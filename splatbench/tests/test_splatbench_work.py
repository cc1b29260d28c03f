"""The benchmark's work counts and roofline arithmetic on hand-worked cases."""
import math

import numpy as np
import pytest
import torch

from splatbench.metrics import work
from splatbench.reference import render as R


def one_tile(xys, conics, opacity, depths):
    """Splats already projected onto one 16 x 16 tile."""
    n = len(xys)
    s = dict(xys=torch.tensor(xys, dtype=torch.float32),
             conics=torch.tensor(conics, dtype=torch.float32),
             opacity=torch.tensor(opacity, dtype=torch.float32),
             depths=torch.tensor(depths, dtype=torch.float32),
             radii=torch.full((n,), 8, dtype=torch.int32),
             valid=torch.ones(n, dtype=torch.bool),
             rgb=torch.ones((n, 3)))
    return s, R.bin_tiles(s, 16, 16, 16, 16)


def box(a, b, c, op):
    det = a * c - b * b
    s2 = 2.0 * (max(math.log(255.0 * op), 0.0) * 1.1 + 0.1) / det
    return math.sqrt(s2 * c) * 1.01 + 0.5, math.sqrt(s2 * a) * 1.01 + 0.5


def test_one_splat():
    # sigma = (dx^2 + dy^2) / 8 around (7, 7): a round splat, sd 2 px.
    s, t = one_tile([[7.0, 7.0]], [[0.25, 0.0, 0.25]], [0.8], [1.0])
    got = R.count_work(s, t)
    ex, ey = box(0.25, 0.0, 0.25, 0.8)
    y, x = np.mgrid[0:16, 0:16]
    inside = (np.abs(x - 7) <= ex) & (np.abs(y - 7) <= ey)
    alpha = 0.8 * np.exp(-((x - 7.0) ** 2 + (y - 7.0) ** 2) / 8)
    kept = alpha >= 1 / 255
    # One entry: every pixel walks it; every kept pixel's last contributor is it.
    assert got["k1_box"] == inside.sum()
    assert got["kept"] == kept.sum() and got["k2_box"] == (inside & kept).sum()
    assert got["entries"] == 1 and got["pixels"] == 256 and got["splats"] == 1


def test_two_opaque_splats_stop_at_the_second():
    # Both splats give alpha 0.999 at every pixel: after the first T = 1e-3;
    # the second would take it to 1e-6 <= 1e-4, so the walk stops there
    # (walked, not kept).
    wide = [[1e-6, 0.0, 1e-6]] * 2
    s, t = one_tile([[7.0, 7.0], [7.0, 7.0]], wide, [1.0, 1.0], [1.0, 2.0])
    got = R.count_work(s, t)
    assert got["entries"] == 2
    assert got["k1_box"] == 2 * 256  # both walked at every pixel, the boxes unbounded
    assert got["kept"] == 256 and got["k2_box"] == 256
    img = R.composite(s, t, 16, 16, torch.zeros(3))
    assert torch.allclose(img, torch.full((16, 16, 3), 0.999))


def test_formulas_by_hand():
    w = dict(k1_box=1000, k2_box=900, kept=500, entries=30, valid=10, splats=12, tiles=2,
             pixels=2048)
    assert work.k1(w) == (16000, 40 * 10 + 4 * 30 + 24 * 2048)
    assert work.k2(w) == (16 * 900 + 60 * 500, 80 * 10 + 4 * 30 + 44 * 2048)
    assert work.binning(w) == (0, 33 * 12 + 4 * 30 + 8 * 2)
    assert work.s1(w, 16) == (500 * 12, 12 * (4 * (3 + 3 + 4 + 48 + 1) + 1 + 45))
    assert work.s2(w, 16) == (1500 * 12, 12 * (2 * 236 + 40))
    # SSIM at 20 x 30: 10 x 30 outputs of the vertical pass, 10 x 20 of the
    # horizontal, 5 maps x 3 channels, 22 FLOP each, forward and backward.
    blur = 22 * 15 * (10 * 30 + 10 * 20)
    assert work.ssim_flop(20, 30) == 2 * blur + 2 * 40 * 3 * 10 * 20
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


class _Trace:
    def __init__(self, secs, n):
        self.secs, self.n = secs, n

    def kernel_s(self, names):
        return self.secs, self.n


class _Ctx:
    def __init__(self, trace, work_):
        self.trace, self.work = trace, work_


def test_roofline_absent_when_no_kernel_ran():
    w = [dict(k1_box=10 ** 9, valid=0, entries=0, pixels=0)]
    assert work.roofline_pct(_Ctx(_Trace(0.0, 0), w), ["k"], work.k1) is None
    pct = work.roofline_pct(_Ctx(_Trace(16e9 / 67e12 * 2, 1), w), ["k"], work.k1)
    assert pct == pytest.approx(50.0)
