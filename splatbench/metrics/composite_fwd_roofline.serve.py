"""K1 (``csrc/composite_fwd.cu``) in served frames: its bound
(``work.k1``) over its device time, in %. Moves ``frames_per_s``."""
from splatbench.metrics import work

KERNELS = ("composite_fwd_kernel",)


def read(ctx):
    return work.roofline_pct(ctx, KERNELS, work.k1)
