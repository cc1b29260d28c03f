"""S1 (``csrc/splat_fwd.cu``: projection, SH colours, opacities) in served
frames: its bound (``work.s1``) over its device time, in %. Moves
``frames_per_s``."""
from splatbench.metrics import work

KERNELS = ("splat_fwd_kernel",)


def read(ctx):
    k = (ctx.config["sh_degree"] + 1) ** 2
    return work.roofline_pct(ctx, KERNELS, lambda w: work.s1(w, k))
