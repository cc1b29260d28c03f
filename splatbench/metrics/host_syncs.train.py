"""Host syncs a ``Trainer`` step inside the program's ``ts.*`` spans (the
Trainer host loop and the train step; ``spans.SYNCS``). Moves
``train_step_ms``."""
from splatbench.metrics import spans


def read(ctx):
    return spans.syncs_per_call(ctx)
