"""Device ms a step of the kernels launched inside the program's
``ts.composite.reduce`` span: the compositing backward's per-entry to
per-splat reduction (``rasterize_cuda.reduce_entry_grads``) and the zero
row's ``cat``. Moves ``train_step_ms``."""

OPS = ("ts.composite.reduce",)


def read(ctx):
    secs = ctx.trace.op_s(OPS)
    if not secs or not ctx.calls:
        return None
    return 1e3 * secs / ctx.calls
