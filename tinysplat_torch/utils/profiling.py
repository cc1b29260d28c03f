"""``torch.profiler`` windows: the program's spans, the top-ops table and the
kernel-busy share.

The port's counterpart of ``tinysplat_tpu.utils.profiling`` (trace capture)
and ``tinysplat_tpu.utils.xplane.print_top_ops`` (the per-op table of a
trace). ``Trainer``'s profile window and the profiling tools
(``scripts/profile_bench.py``, ``scripts/profile_train_step.py``) share it:

- ``window(fn, iters, device, logdir)``: run ``fn`` ``iters`` times under
  the profiler (CUDA activity on a CUDA device), the device synchronized
  before the window closes; a Chrome trace goes to ``logdir/trace.json``.
- ``print_top_ops(prof, top, iters)``: the JAX table's columns (``ms/iter``,
  ``count``, ``op``; the total per iteration in the header) over the
  device's kernels when the window traced any, else over the CPU ops'
  self time.
- ``kernel_busy_share(prof)``: the share of the window in which a kernel ran.
- ``print_window(prof, device, what)``: ``key_averages()``'s table by
  ``time_key(device)`` and the busy share, as the trainer prints them.
- ``span(name)``: a ``record_function`` range named ``ts.<layer>...`` at a
  layer boundary of the program, in the same trace as torch's ops and the
  device's kernels (one clock). It is recorded exactly when a profiler
  records the calling thread (``torch.autograd._profiler_enabled()``, which
  is thread-local and which autograd carries into its device threads);
  otherwise it is one shared null context, so an untraced step pays a flag
  read per span. The ``ts.`` prefix tells the program's spans from torch's
  own ranges.
- ``op_range(name)``: an operator-scope range around a kernel launched
  through ctypes, recorded under the same condition. The profiler links a
  kernel to the innermost *operator* open at its launch, never to a user
  range such as a span; inside a Function's backward that operator is
  autograd's node, which encloses the span, so without this range the
  kernel's time would fall outside its span.
"""
from __future__ import annotations

import collections
import contextlib
import os
from typing import Callable, List, Optional, Tuple

import torch

from .device import synchronize

_UNTRACED = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``name`` while a profiler records this thread, else
    the shared null context. Names start with ``ts.``."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _UNTRACED


def op_range(name: str):
    """An operator-scope profiler range ``name`` while a profiler records
    this thread, else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _UNTRACED


def time_key(device) -> str:
    """``key_averages()``'s column of an op's time: device time on a CUDA
    device (``device_time_total``; the older ``cuda_time_total`` is an alias
    that the table's sort maps to it), CPU time on the CPU."""
    return "device_time_total" if torch.device(device).type == "cuda" else "cpu_time_total"


def activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def window(fn: Callable[[], object], iters: int, device, logdir: Optional[str] = None):
    """Profile ``iters`` calls of ``fn``; returns the stopped profiler.
    The device is synchronized before the window closes, so every kernel
    queued by the calls is inside it."""
    prof = torch.profiler.profile(activities=activities(device))
    prof.start()
    try:
        for _ in range(iters):
            fn()
        synchronize(device)
    finally:
        prof.stop()
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return prof


def _events(prof) -> List[Tuple[str, int, int, int, bool]]:
    """(name, start ns, end ns, thread, on the device) of every event of a
    stopped window, read from the profiler's raw results: building
    ``prof.events()`` costs ~65 us an event in Python (13 s for the 200,000
    ops of a plain-version render on the CPU), reading them ~4 us. The
    device's user annotations are left out: they span the kernels of a
    ``record_function`` range (``Optimizer.step#...``), gaps included."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
             e.device_type() == cuda)
            for e in prof.profiler.kineto_results.events()
            if not (e.is_hidden_event() or (e.is_user_annotation()
                                            and e.device_type() == cuda))]


def kernel_busy_share(prof) -> Optional[float]:
    """Share of a profiler window's traced wall time in which at least one
    CUDA kernel ran (None when the trace holds no device events)."""
    events = _events(prof)
    kernels = sorted((s, e) for _, s, e, _, dev in events if dev)
    if not kernels:
        return None
    lo = min(s for _, s, _, _, _ in events)
    hi = max(e for _, _, e, _, _ in events)
    busy, cur_s, cur_e = 0, None, None
    for s, e in kernels:
        if cur_e is None or s > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / max(hi - lo, 1)


def busy_share_line(share: Optional[float], what: str) -> str:
    return (f"{what}: a CUDA kernel ran in "
            f"{'no device trace' if share is None else f'{share:.4f}'} of the traced "
            "wall time")


def print_window(prof, device, what: str, row_limit: int = 25):
    """Print ``key_averages()``'s table sorted by ``time_key(device)`` and
    the window's kernel-busy share; returns (table, share)."""
    table = prof.key_averages().table(sort_by=time_key(device), row_limit=row_limit)
    share = kernel_busy_share(prof)
    print(table, flush=True)
    print(busy_share_line(share, what), flush=True)
    return table, share


def top_ops(prof):
    """(line, {op: (total ms, count)}): the device's kernels (and copies)
    by their traced duration when the window holds any, else the CPU ops
    by their self time (their duration less that of the ops nested in them
    on their thread)."""
    events = _events(prof)
    totals, counts = collections.defaultdict(int), collections.Counter()
    device = [(name, s, e) for name, s, e, _, dev in events if dev]
    if device:
        line = "device kernels"
        for name, s, e in device:
            totals[name] += e - s
            counts[name] += 1
    else:
        line = "CPU ops, self time"
        # thread -> open ops [name, start, end, ns of the ops nested in it, parent]
        stacks = collections.defaultdict(list)
        for name, s, e, thread, _ in sorted(events, key=lambda x: (x[3], x[1], -x[2])):
            stack = stacks[thread]
            while stack and not e <= stack[-1][2]:
                _close(stack.pop(), totals, counts)
            parent = stack[-1] if stack else None
            if parent is not None and parent[0] != name:
                parent[3] += e - s
            stack.append([name, s, e, 0, parent])
        for stack in stacks.values():
            while stack:
                _close(stack.pop(), totals, counts)
    return line, {k: (totals[k] / 1e6, counts[k]) for k in totals}


def _close(op, totals, counts) -> None:
    """Count a closed op; one nested in an op of its own name (an overload
    the op dispatches to) is folded into it, as ``key_averages()`` does."""
    name, s, e, nested, parent = op
    if parent is not None and parent[0] == name:
        parent[3] += nested
        return
    totals[name] += max(e - s - nested, 0)
    counts[name] += 1


def print_top_ops(prof, top: int = 30, iters: int = 1) -> dict:
    """Print the window's top ``top`` ops by time per iteration, as the JAX
    package's ``print_top_ops`` prints a trace's; returns the printed
    ``lines``, the ``rows`` (op, ms/iter, count), the ``line`` measured and
    its ``total_ms_per_iter``."""
    line, agg = top_ops(prof)
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    total = sum(ms for ms, _ in agg.values()) / iters
    lines = [f"{'ms/iter':>9}  {'count':>6}  op  (line '{line}' total {total:.1f} ms/iter)"]
    lines += [f"{ms / iters:9.2f}  {cnt:6d}  {op[:100]}" for op, (ms, cnt) in rows]
    for text in lines:
        print(text, flush=True)
    return {"lines": lines, "line": line, "total_ms_per_iter": total,
            "rows": [(op, ms / iters, cnt) for op, (ms, cnt) in rows]}
