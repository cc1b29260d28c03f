"""95th percentile of the frame time over the window's frames outside the
profiler (each from the call to its host array, by the host clock): a
3 ms frame is too short for the host clock to time on its own, so this tail
has no bound. Moves ``frames_per_s``."""


def read(ctx):
    return ctx.window.get("frame_ms_p95")
