"""Device ms a step of the work launched inside the program's
``ts.train_step.density`` span: the forward of SuGaR's density term
(``regularizers/density.density_loss``: the neighbours' gathers, the
mixture density, the depth lookup), each device event matched to its
launch (``launched.py``). The term's backward runs on autograd's thread,
outside the span, so it is not counted here; its depth cotangent reaches
the compositing backward K2. Moves ``train_step_ms``."""
from splatbench.metrics import launched

SPAN = "ts.train_step.density"


def read(ctx):
    rec = launched.records(ctx.trace)
    if rec is None or not ctx.calls:
        return None
    ns, spans = launched.device_ns(rec, (SPAN,))
    if not ns or not spans:
        return None
    return ns / 1e6 / ctx.calls
