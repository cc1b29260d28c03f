"""Device-idle ms a ``Trainer`` step whose innermost open span is the
Trainer host loop's (``ts.trainer.*``, ``ts.trainer.render_camera``
excepted): ``train_loop.Trainer._train_step`` outside ``make_train_step``,
the rule of ``spans.py``. Moves ``train_step_ms``."""
from splatbench.metrics import spans


def host_loop(name: str) -> bool:
    return name.startswith("ts.trainer.") and name != "ts.trainer.render_camera"


def read(ctx):
    return spans.idle_ms(ctx, host_loop)
