"""Device-idle ms a frame inside ``ts.trainer.render_camera``
(``Trainer.render_camera`` -> ``render.render``, the spans inside it
included); the client's copy to its host buffer is outside. Moves
``frames_per_s``."""
from splatbench.metrics import spans


def read(ctx):
    return spans.idle_under_ms(ctx, ["ts.trainer.render_camera"])
