"""Device ms a step of the kernels that SSIM's convolutions and their
transposes launch (the loss's blur: ``aten::conv2d`` forward,
``aten::conv_transpose2d`` in its backward), attributed to the op that
launched them. Moves ``train_step_ms``."""

OPS = ("aten::conv2d", "aten::conv_transpose2d", "aten::convolution_backward")


def read(ctx):
    secs = ctx.trace.op_s(OPS)
    if not secs or not ctx.calls:
        return None
    return 1e3 * secs / ctx.calls
