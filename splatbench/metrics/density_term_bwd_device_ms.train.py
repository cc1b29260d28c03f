"""Device ms a step of the work launched inside the program's
``ts.density.backward`` span: the backward of SuGaR's density term (the
``density_bwd`` kernel of ``csrc/density.cu`` and its zeroed output's fill,
on autograd's thread), each device event matched to its launch
(``launched.py``). While the span is open autograd's thread alone launches:
the main thread waits in ``backward``. None where the program has no such
span (a program that runs the term's backward as torch ops). Moves
``train_step_ms``."""
from splatbench.metrics import launched

SPAN = "ts.density.backward"


def read(ctx):
    rec = launched.records(ctx.trace)
    if rec is None or not ctx.calls:
        return None
    ns, spans = launched.device_ns(rec, (SPAN,))
    if not ns or not spans:
        return None
    return ns / 1e6 / ctx.calls
