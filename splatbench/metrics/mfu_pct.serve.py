"""A frame's required float32 FLOP (``work.frame_flop``: K1 and S1, from the
traced frames' counts) over the frame time of this run's measured window at
the published FP32 peak. Moves ``frames_per_s``."""
from splatbench.metrics import work


def read(ctx):
    if not ctx.work or ctx.call_s <= 0:
        return None
    k = (ctx.config["sh_degree"] + 1) ** 2
    flop = sum(work.frame_flop(w, k) for w in ctx.work) / len(ctx.work)
    return 100.0 * flop / (ctx.call_s * work.FLOP_S)
