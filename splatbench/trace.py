"""A ``torch.profiler`` window inside the measured window, and what the
per-layer metrics read from it.

- Device events (kernels, copies, fills) come from the profiler's raw
  kineto events; the device's busy time is the union of their intervals
  and the window runs from the first traced event to the last (the
  arithmetic of ``kernel_busy_share`` in the program's
  ``utils/profiling.py``, copied).
- A kernel is found by its name (``kernel_s``): a whole word of the traced
  symbol, so ``splat_bwd_kernel`` does not match ``splat_bwd_fold_kernel``.
- Device time is attributed to the host op that launched it (``op_s``)
  through the profiler's ``FunctionEvent`` tree: an op's own kernels and
  those of the ops nested in it, each counted once.
- ``breakdown``: the ten device operations that took most time, and the ten
  host ops most often open while the device sat idle, by the idle seconds.
"""
from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch

TOP = 10


def start(device) -> "torch.profiler.profile":
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop(prof, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()


def _word(name: str):
    return re.compile(r"(?<![A-Za-z0-9_])" + re.escape(name) + r"(?![A-Za-z0-9_])")


class Trace:
    """What one stopped profiler window holds."""

    def __init__(self, prof):
        self._prof = prof
        cuda = torch.autograd.DeviceType.CUDA
        self.device: List[Tuple[str, int, int]] = []  # (name, start ns, end ns)
        self.host: List[Tuple[int, int, str]] = []  # (start ns, end ns, name)
        for e in prof.profiler.kineto_results.events():
            if e.is_hidden_event():
                continue
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    self.device.append((e.name(), s, t))
            else:
                self.host.append((s, t, e.name()))
        ends = [t for _, _, t in self.device] + [t for _, t, _ in self.host]
        starts = [s for _, s, _ in self.device] + [s for s, _, _ in self.host]
        self.window_ns = (max(ends) - min(starts)) if starts else 0
        self._busy = _union(sorted((s, t) for _, s, t in self.device))

    @property
    def window_s(self) -> float:
        return self.window_ns / 1e9

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self._busy) / 1e9

    def kernel_s(self, names: Iterable[str]) -> Tuple[float, int]:
        """(device seconds, launches) of the device events whose symbol holds
        one of ``names`` as a whole word."""
        pats = [_word(n) for n in names]
        total, count = 0, 0
        for name, s, t in self.device:
            if any(p.search(name) for p in pats):
                total += t - s
                count += 1
        return total / 1e9, count

    def op_s(self, names: Iterable[str]) -> Optional[float]:
        """Device seconds of the kernels launched inside host ops named one of
        ``names`` (outermost match only), or None when no such op ran."""
        names = set(names)
        events = self._prof.events()
        found, total = False, 0.0
        for e in events:
            if e.name not in names or e.device_type != torch.autograd.DeviceType.CPU:
                continue
            parent, nested = e.cpu_parent, False
            while parent is not None:
                if parent.name in names:
                    nested = True
                    break
                parent = parent.cpu_parent
            if nested:
                continue
            found = True
            total += _subtree_kernel_us(e)
        return total / 1e6 if found else None

    def breakdown(self) -> Dict[str, list]:
        ops = collections.Counter()
        for name, s, t in self.device:
            ops[name[:160]] += t - s
        gaps = collections.Counter()
        host = sorted(self.host)
        starts = [s for s, _, _ in host]
        for (_, e0), (s1, _) in zip(self._busy, self._busy[1:]):
            gaps[_open_at(host, starts, e0)] += s1 - e0
        return {"device_ops": [[k, v / 1e9] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v / 1e9] for k, v in gaps.most_common(TOP)]}


def _subtree_kernel_us(e) -> float:
    total = sum(k.duration for k in e.kernels)
    for child in e.cpu_children:
        total += _subtree_kernel_us(child)
    return total


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, t in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def _open_at(host, starts, t: int, reach: int = 20000) -> str:
    """The innermost host op open at ``t`` (the latest-starting one that
    contains it), on any thread."""
    i = bisect.bisect_right(starts, t) - 1
    lo = max(i - reach, -1)
    while i > lo:
        s, e, name = host[i]
        if e > t:
            return name
        i -= 1
    return "(no host op)"
