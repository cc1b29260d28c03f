"""Hopper counterparts of the JAX package's kernel probes (``scripts/probe_*.py``).

``bitcast`` (P1): f32 carried exactly through packed bf16 / u16 lanes.
``op_costs`` (P2): what each elementwise op and triangular-product route
costs inside a kernel on the card.
"""
import statistics

# Cycles of the spin kernel queued ahead of a device-only timing: ~5 ms at
# the H100's 1980 MHz, longer than the host takes to issue one call.
SPIN_CYCLES = 10_000_000


def timed_ms(fn, reps: int, device_only: bool = False) -> float:
    """Median CUDA-event time (ms) of ``fn`` over ``reps`` calls.

    With ``device_only`` a spin kernel is queued before each call, so the
    host issues the call's launches while the card is still busy and the
    events time the device work alone. Without it, a call whose host path
    (Python wrapper, allocation, launch) outlasts its kernels is timed at
    the host's pace: right for a layer, wrong for a kernel against its bound.
    """
    import torch

    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
