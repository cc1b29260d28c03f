"""A training step's required float32 FLOP (``work.step_flop``: K1, K2, S1,
S2, the loss and Adam, from the traced steps' counts) over the step time of
this run's measured window at the published FP32 peak. Moves
``train_step_ms``."""
from splatbench.metrics import work


def read(ctx):
    if not ctx.work or ctx.call_s <= 0:
        return None
    k = (ctx.config["sh_degree"] + 1) ** 2
    params = ctx.config["n_splats"] * (3 + 3 * k + 3 + 4 + 1)
    flop = sum(work.step_flop(w, k, ctx.config["height"], ctx.config["width"], params)
               for w in ctx.work) / len(ctx.work)
    return 100.0 * flop / (ctx.call_s * work.FLOP_S)
