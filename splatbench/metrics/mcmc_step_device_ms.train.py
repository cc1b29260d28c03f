"""Device ms a step of the kernels launched inside the program's
``ts.train_step.mcmc_noise`` and ``ts.train_step.mcmc_sparsity`` spans:
3DGS-MCMC's position noise after Adam (``models/densify_mcmc.apply_noise``
and its draw) and the forward of its two sparsity terms. The terms'
backward runs on autograd's thread, outside the spans. Moves
``train_step_ms``."""

OPS = ("ts.train_step.mcmc_noise", "ts.train_step.mcmc_sparsity")


def read(ctx):
    secs = ctx.trace.op_s(OPS)
    if not secs or not ctx.calls:
        return None
    return 1e3 * secs / ctx.calls
