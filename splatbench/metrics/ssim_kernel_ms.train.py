"""Device ms a step of the kernels launched inside the program's ``ts.ssim``
and ``ts.ssim.backward`` spans: the loss layer's SSIM forward (L1) and its
backward (L2, from autograd's device thread). Moves ``train_step_ms``."""

OPS = ("ts.ssim", "ts.ssim.backward")


def read(ctx):
    secs = ctx.trace.op_s(OPS)
    if not secs or not ctx.calls:
        return None
    return 1e3 * secs / ctx.calls
