"""The program's own spans in a traced window, and the device's idle time and
host syncs put down to them: the arithmetic the span metrics share.

The program (``tinysplat_torch``) opens a ``record_function`` range named
``ts.<layer>...`` at each layer boundary while a profiler records; they are
host events of ``Trace.host``, on the device events' clock.

- Idle: the traced window less the union of the device events (the rule of
  ``device_idle_pct``), cut where spans open and close. Each piece goes to
  the innermost ``ts.*`` span open over it: the latest-starting one that
  contains it, on any thread; a piece under none goes to ``OUTSIDE``.
- A host sync is a runtime call in ``SYNCS`` (a blocking ``cudaMemcpy``, or
  a wait on a stream, an event or the device: a blocking
  ``cudaMemcpyAsync`` is followed by ``cudaStreamSynchronize``). It goes to
  the innermost ``ts.*`` span open at its start.

``trace`` is anything with ``host`` [(start ns, end ns, name)] and
``device`` [(name, start ns, end ns)], as ``splatbench.trace.Trace`` has.
"""
from __future__ import annotations

import bisect
import collections
from typing import Callable, Dict, List, Optional, Tuple

PREFIX = "ts."
OUTSIDE = "(outside the program)"
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"})


def program_spans(trace) -> List[Tuple[int, int, str]]:
    """The ``ts.*`` host events, by start (the longer first at one start)."""
    return sorted(((s, e, n) for s, e, n in trace.host if n.startswith(PREFIX)),
                  key=lambda x: (x[0], -x[1]))


def window(trace) -> Tuple[int, int]:
    """(first start, last end) over every traced event: ``Trace.window_ns``'s
    ends."""
    starts = [s for _, s, _ in trace.device] + [s for s, _, _ in trace.host]
    ends = [t for _, _, t in trace.device] + [t for _, t, _ in trace.host]
    return min(starts), max(ends)


def idle_intervals(trace) -> List[Tuple[int, int]]:
    """The window's intervals in which no device event ran."""
    lo, hi = window(trace)
    gaps, cur = [], lo
    for s, t in sorted((s, t) for _, s, t in trace.device):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def timeline(trace) -> List[Tuple[int, int, str]]:
    """(start, end, owner) pieces that tile the window, cut at every span's
    start and end; the owner is the innermost ``ts.*`` span open over the
    piece, or ``OUTSIDE``."""
    spans = program_spans(trace)
    lo, hi = window(trace)
    cuts = sorted({lo, hi} | {t for s, e, _ in spans for t in (s, e) if lo < t < hi})
    starts = [s for s, _, _ in spans]
    out = []
    for a, b in zip(cuts, cuts[1:]):
        owner = OUTSIDE
        for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if spans[i][1] >= b:
                owner = spans[i][2]
                break
        out.append((a, b, owner))
    return out


def _overlap(gaps, pieces) -> Dict[str, int]:
    """ns of ``gaps`` under each owner of ``pieces`` (both sorted, the
    pieces not overlapping one another)."""
    out: Dict[str, int] = collections.Counter()
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, owner = pieces[k]
            out[owner] += min(b, e) - max(a, s)
            k += 1
    return dict(out)


def idle_by_span(trace) -> Dict[str, int]:
    """Idle ns by the innermost span open over it (``OUTSIDE`` included):
    the values add up to the window less the device's busy union."""
    return _overlap(idle_intervals(trace), timeline(trace))


def idle_under(trace, names) -> int:
    """Idle ns inside the spans named one of ``names``, whatever spans are
    open inside them."""
    merged: List[List[int]] = []
    for s, e, n in program_spans(trace):
        if n not in names:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    pieces = [(s, e, "in") for s, e in merged]
    return _overlap(idle_intervals(trace), pieces).get("in", 0)


def syncs_by_span(trace) -> Dict[str, int]:
    """Host syncs by the innermost span open at their start (``OUTSIDE``
    included)."""
    pieces = timeline(trace)
    starts = [a for a, _, _ in pieces]
    out: Dict[str, int] = collections.Counter()
    for s, _, name in trace.host:
        if name in SYNCS:
            i = bisect.bisect_right(starts, s) - 1
            out[pieces[i][2] if i >= 0 and s < pieces[i][1] else OUTSIDE] += 1
    return dict(out)


def _traced(ctx) -> bool:
    """A device was traced, and so were the program's spans."""
    t = ctx.trace
    return bool(ctx.calls) and t is not None and bool(t.device) and bool(program_spans(t))


def idle_ms(ctx, owner: Callable[[str], bool]) -> Optional[float]:
    """Idle ms a traced call under the spans ``owner`` accepts as the
    innermost; None when the trace holds no device event or none of the
    program's spans."""
    if not _traced(ctx):
        return None
    by = idle_by_span(ctx.trace)
    return sum(v for k, v in by.items() if k != OUTSIDE and owner(k)) / 1e6 / ctx.calls


def idle_under_ms(ctx, names) -> Optional[float]:
    """Idle ms a traced call inside the spans ``names``; None as above."""
    if not _traced(ctx):
        return None
    return idle_under(ctx.trace, set(names)) / 1e6 / ctx.calls


def syncs_per_call(ctx) -> Optional[float]:
    """Host syncs a traced call inside the program's spans; None as above."""
    if not _traced(ctx):
        return None
    by = syncs_by_span(ctx.trace)
    return sum(v for k, v in by.items() if k != OUTSIDE) / ctx.calls
