"""Host syncs a frame inside the program's ``ts.*`` spans (``spans.SYNCS``;
the client's copy to its host buffer is the benchmark's, outside them).
Moves ``frames_per_s``."""
from splatbench.metrics import spans


def read(ctx):
    return spans.syncs_per_call(ctx)
