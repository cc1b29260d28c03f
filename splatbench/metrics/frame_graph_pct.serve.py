"""Share of the traced frames that replayed the frame's CUDA graph: 100 x
the ``ts.render.graph_replay`` spans (``Trainer.render_camera`` through
``frame_graph.FrameGraph``) in the traced window over the traced frames.
None where the program opens no such span. Moves ``frames_per_s``."""
from splatbench.metrics import spans

SPAN = "ts.render.graph_replay"


def read(ctx):
    if not ctx.calls or ctx.trace is None:
        return None
    replays = sum(1 for _, _, name in spans.program_spans(ctx.trace) if name == SPAN)
    return 100.0 * replays / ctx.calls if replays else None
