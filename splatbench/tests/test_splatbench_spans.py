"""``metrics/spans.py`` on hand-made traces, each answer worked out by hand,
and the six span metrics through their readers. Times are in ns; ``MS`` ns
make a millisecond."""
import types

import pytest

from splatbench import spec
from splatbench.metrics import spans

MS = 1_000_000
OUT = spans.OUTSIDE


def trace(host, device, op_s=None):
    """``host`` [(start, end, name)], ``device`` [(start, end)] kernels."""
    return types.SimpleNamespace(host=host, device=[("k", s, e) for s, e in device],
                                 op_s=op_s or (lambda names: None))


def ctx(t, calls=1):
    return types.SimpleNamespace(trace=t, calls=calls)


def test_nested_spans():
    # ts.a [0, 100] holds ts.a.b [20, 60]; kernels at [0, 10], [30, 40],
    # [90, 100]. Idle [10, 30]: 10 under a, 10 under b; [40, 90]: 20 under
    # b, 30 under a.
    t = trace([(0, 100, "ts.a"), (20, 60, "ts.a.b"), (22, 25, "aten::mm")],
              [(0, 10), (30, 40), (90, 100)])
    assert spans.idle_by_span(t) == {"ts.a": 40, "ts.a.b": 30}
    assert spans.idle_under(t, {"ts.a"}) == 70 and spans.idle_under(t, {"ts.a.b"}) == 30


def test_a_gap_across_two_spans():
    # Siblings ts.x [0, 50] and ts.y [50, 100]; the gap [40, 70] splits 10 / 20.
    t = trace([(0, 50, "ts.x"), (50, 100, "ts.y")], [(0, 40), (70, 100)])
    assert spans.idle_by_span(t) == {"ts.x": 10, "ts.y": 20}


def test_spans_on_two_threads():
    # The backward's span (another thread) opens inside the step's: the
    # latest-starting span that contains a piece owns it. Idle [20, 90]:
    # [20, 30] main, [30, 80] bwd, [80, 90] main.
    t = trace([(0, 100, "ts.main"), (30, 80, "ts.bwd"), (35, 45, "aten::mm")],
              [(0, 20), (90, 100)])
    assert spans.idle_by_span(t) == {"ts.main": 20, "ts.bwd": 50}
    # Two spans that overlap without nesting: over [40, 60] both are open and
    # q started later. Idle [10, 100]: p [10, 40] 30, q [40, 100] 60.
    t = trace([(0, 60, "ts.p"), (40, 100, "ts.q")], [(0, 10)])
    assert spans.idle_by_span(t) == {"ts.p": 30, "ts.q": 60}


def test_a_sync_outside_every_span():
    # Pieces: [0, 10] outside, [10, 30] a, [30, 40] a.b, [40, 50] a,
    # [50, 70] outside. Kernels [0, 5], [45, 48]: idle 5 + 20 outside,
    # 20 + 5 + 2 under a, 10 under a.b = 62 = 70 - 8.
    host = [(10, 50, "ts.a"), (30, 40, "ts.a.b"),
            (5, 8, "cudaStreamSynchronize"), (20, 25, "cudaStreamSynchronize"),
            (32, 33, "cudaEventSynchronize"), (35, 36, "cudaMemcpyAsync"),
            (37, 38, "cudaLaunchKernel"), (60, 70, "cudaDeviceSynchronize")]
    t = trace(host, [(0, 5), (45, 48)])
    assert spans.syncs_by_span(t) == {OUT: 2, "ts.a": 1, "ts.a.b": 1}
    idle = spans.idle_by_span(t)
    assert idle == {OUT: 25, "ts.a": 27, "ts.a.b": 10}
    assert sum(idle.values()) == 70 - 8
    assert spans.syncs_per_call(ctx(t, calls=2)) == 1.0


def test_no_spans_or_no_device_reads_nothing():
    no_spans = trace([(0, 100, "aten::mm"), (10, 20, "cudaStreamSynchronize")], [(0, 10)])
    no_device = trace([(0, 100, "ts.a")], [])
    for t in (no_spans, no_device):
        assert spans.idle_ms(ctx(t), lambda n: True) is None
        assert spans.idle_under_ms(ctx(t), ["ts.a"]) is None
        assert spans.syncs_per_call(ctx(t)) is None
    assert spans.idle_ms(ctx(trace([(0, 100, "ts.a")], [(0, 10)]), calls=0),
                         lambda n: True) is None


def step_trace():
    # One step, in ms: the camera [0, 20], the train step [20, 80] with K1's
    # span [30, 50] inside, the post-step [80, 100]; kernels [10, 15],
    # [35, 45], [85, 90]. Idle: camera 10 + 5, train step 10 + 30,
    # composite 5 + 5, post-step 5 + 10; two syncs in the camera, one in
    # the post-step, one outside (at 100).
    host = [(0, 100, "ts.trainer.step"), (0, 20, "ts.trainer.camera"),
            (20, 80, "ts.train_step"), (30, 50, "ts.render.composite"),
            (80, 100, "ts.trainer.post_step"),
            (2, 3, "cudaStreamSynchronize"), (5, 6, "cudaStreamSynchronize"),
            (81, 82, "cudaMemcpy"), (100, 100, "cudaDeviceSynchronize")]
    host = [(s * MS, e * MS, n) for s, e, n in host]
    return trace(host, [(s * MS, e * MS) for s, e in [(10, 15), (35, 45), (85, 90)]],
                 op_s=lambda names: 0.006 if list(names) == ["ts.composite.reduce"] else None)


@pytest.mark.parametrize("name,want", [
    ("host_loop_idle_ms.train", 30.0 / 2), ("train_step_idle_ms.train", 50.0 / 2),
    ("host_syncs.train", 3 / 2), ("grad_reduce_device_ms.train", 6.0 / 2)])
def test_train_metrics(name, want):
    assert spec.metric_reader(name)(ctx(step_trace(), calls=2)) == pytest.approx(want)


def test_frame_metrics():
    # A frame [10, 60] holding the camera [10, 20] and the render [20, 60];
    # the client's copy [60, 70] and its sync lie outside. Kernels [25, 40],
    # [60, 70]: idle inside the frame [10, 25] + [40, 60] = 35.
    host = [(10, 60, "ts.trainer.render_camera"), (10, 20, "ts.trainer.camera"),
            (20, 60, "ts.render.composite"), (12, 13, "cudaStreamSynchronize"),
            (14, 15, "cudaStreamSynchronize"), (61, 70, "cudaStreamSynchronize")]
    t = trace([(s * MS, e * MS, n) for s, e, n in host],
              [(25 * MS, 40 * MS), (0, 10 * MS), (60 * MS, 70 * MS)])
    assert spec.metric_reader("frame_idle_ms.serve")(ctx(t)) == pytest.approx(35.0)
    assert spec.metric_reader("host_syncs.serve")(ctx(t)) == 2.0


def test_reduce_metric_reads_nothing_without_the_span():
    t = trace([], [(0, 10)])
    assert spec.metric_reader("grad_reduce_device_ms.train")(ctx(t, calls=8)) is None
