"""Device ms a traced probe rebuild of the work launched inside the
program's ``ts.density.knn`` spans: the density probe's brute-force KNN
(``regularizers/density.knn_indices``: one distance block and top-k a chunk
of points, the exact redo of tied rows), each device event matched to its
launch (``launched.py``). None when no rebuild was traced. Moves
``train_step_ms``."""
from splatbench.metrics import launched

SPAN = "ts.density.knn"


def read(ctx):
    rec = launched.records(ctx.trace)
    if rec is None:
        return None
    ns, rebuilds = launched.device_ns(rec, (SPAN,))
    if not ns or not rebuilds:
        return None
    return ns / 1e6 / rebuilds
