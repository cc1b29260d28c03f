"""Wall ms of a 3DGS-MCMC refine pass: the mean length of the program's
``ts.trainer.mcmc_relocate`` host spans in the traced window
(``models/densify_mcmc.relocate_and_grow``, which ends in a host read of
its counts, so the span holds the pass's whole time). None when no pass
was traced. Moves ``train_step_ms``."""

SPAN = "ts.trainer.mcmc_relocate"


def read(ctx):
    if ctx.trace is None:
        return None
    ns = [e - s for s, e, name in ctx.trace.host if name == SPAN]
    if not ns:
        return None
    return sum(ns) / len(ns) / 1e6
