"""Device time of the work a program span launched, matched launch by
launch: the arithmetic ``knn_device_ms.train`` and
``density_term_device_ms.train`` share.

``trace.Trace.op_s`` sums the kernels the profiler's ``FunctionEvent`` tree
hangs under a span, and that tree hangs one kernel on every nested op that
claims it: in one density-probe rebuild on an H100 its subtree held 23,146
kernel entries for 7,782 device events, and ``op_s`` read 1,628.8 ms of
device time inside a 500.5 ms span. Here a device event (kernel, copy or
fill) counts once, for the span open over its launch: the runtime call
(``cu*``) that shares its correlation id starts inside the span. No thread
is matched (the profiler numbers a span's thread and a runtime call's in
two ways): the two spans read here open while the step's main thread
alone launches, before its backward starts on autograd's thread.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Tuple

import torch


class Records(NamedTuple):
    spans: List[Tuple[str, int, int]]  # (name, start ns, end ns) of the ts.* host ranges
    launches: dict  # correlation id -> start ns of a runtime call
    device: List[Tuple[int, int]]  # (correlation id, duration ns) of a device event


def records(trace) -> Optional[Records]:
    """What a traced window holds for the matching (None without a trace)."""
    if trace is None:
        return None
    cuda = torch.autograd.DeviceType.CUDA
    spans, launches, device = [], {}, []
    for e in trace._prof.profiler.kineto_results.events():
        if e.is_hidden_event():
            continue
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.correlation_id(), e.duration_ns()))
        elif e.name().startswith("ts."):
            spans.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name().startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    return Records(spans, launches, device)


def device_ns(rec: Records, names: Iterable[str]) -> Tuple[int, int]:
    """(device ns launched inside the spans named one of ``names``, how many
    such spans)."""
    names = set(names)
    mine = [(s, e) for n, s, e in rec.spans if n in names]
    total = 0
    for corr, dur in rec.device:
        start = rec.launches.get(corr)
        if start is not None and any(s <= start <= e for s, e in mine):
            total += dur
    return total, len(mine)
