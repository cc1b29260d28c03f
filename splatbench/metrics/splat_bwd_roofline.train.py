"""S2 (``csrc/splat_bwd.cu``, and its camera fold when one runs) in
``Trainer`` steps: its bound (``work.s2``) over its device time, in %.
Moves ``train_step_ms``."""
from splatbench.metrics import work

KERNELS = ("splat_bwd_kernel", "splat_bwd_fold_kernel")


def read(ctx):
    k = (ctx.config["sh_degree"] + 1) ** 2
    return work.roofline_pct(ctx, KERNELS, lambda w: work.s2(w, k))
