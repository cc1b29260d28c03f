"""``ssim_kernel_ms.train``'s reader on hand-made traces: the device ms of
the kernels under the program's ``ts.ssim`` and ``ts.ssim.backward`` spans,
a step; nothing where a program has no such span."""
import types

import pytest

from splatbench import spec

NAME = "ssim_kernel_ms.train"


def ctx(op_s, calls):
    return types.SimpleNamespace(trace=types.SimpleNamespace(op_s=op_s), calls=calls)


def test_reads_both_spans_a_step():
    asked = []

    def op_s(names):
        asked.append(tuple(names))
        return 0.0024  # 8 steps of 0.3 ms

    assert spec.metric_reader(NAME)(ctx(op_s, calls=8)) == pytest.approx(0.3)
    assert asked == [("ts.ssim", "ts.ssim.backward")]


@pytest.mark.parametrize("secs,calls", [(None, 8), (0.0, 8), (0.0024, 0)])
def test_reads_nothing_without_the_spans_or_steps(secs, calls):
    assert spec.metric_reader(NAME)(ctx(lambda names: secs, calls)) is None
