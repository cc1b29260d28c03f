"""Wall ms of a SuGaR density-probe rebuild: the mean length of the
program's ``ts.trainer.density_probe`` host spans in the traced window
(``train_loop.Trainer._maybe_refresh_density_probe``: the sampling, the
KNN and the live count, which end in host reads, so the span holds the
rebuild's whole time). None when no rebuild was traced. Moves
``train_step_ms``."""

SPAN = "ts.trainer.density_probe"


def read(ctx):
    if ctx.trace is None:
        return None
    ns = [e - s for s, e, name in ctx.trace.host if name == SPAN]
    if not ns:
        return None
    return sum(ns) / len(ns) / 1e6
