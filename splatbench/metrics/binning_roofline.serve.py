"""B1-B4 (``csrc/binning.cu``: span count, entry emission, the radix sort's
histogram and scatter passes) in served frames: the binning's bound
(``work.binning``) over the four kernels' summed device time, in %. Moves
``frames_per_s``."""
from splatbench.metrics import work

KERNELS = ("bin_count_kernel", "bin_emit_kernel", "radix_hist_kernel", "radix_scatter_kernel")


def read(ctx):
    return work.roofline_pct(ctx, KERNELS, work.binning)
