"""K2 (``csrc/composite_bwd.cu``) in ``Trainer`` steps: its bound
(``work.k2``, FLOP from the analytic gradient) over its device time, in %.
Moves ``train_step_ms``."""
from splatbench.metrics import work

KERNELS = ("composite_bwd_kernel",)


def read(ctx):
    return work.roofline_pct(ctx, KERNELS, work.k2)
