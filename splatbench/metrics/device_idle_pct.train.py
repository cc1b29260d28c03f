"""Share of the traced window of ``Trainer`` steps in which no device
operation ran: 100 (1 - busy / window), busy the union of the device
events' intervals. Moves ``train_step_ms``."""


def read(ctx):
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
