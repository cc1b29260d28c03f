"""Device ms a step of the kernels launched inside torch's own
``Optimizer.step#GaussianAdam.step`` range. Moves ``train_step_ms``."""

OPS = ("Optimizer.step#GaussianAdam.step",)


def read(ctx):
    secs = ctx.trace.op_s(OPS)
    if not secs or not ctx.calls:
        return None
    return 1e3 * secs / ctx.calls
