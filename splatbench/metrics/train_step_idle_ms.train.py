"""Device-idle ms a ``Trainer`` step whose innermost open span is the train
step's (``train.make_train_step``: ``ts.train_step*``) or a layer's inside it
(``ts.render.*``, ``ts.composite.*``, ``ts.splat_inputs.*``), the rule of
``spans.py``. Moves ``train_step_ms``."""
from splatbench.metrics import spans

PREFIXES = ("ts.train_step", "ts.render.", "ts.composite.", "ts.splat_inputs.")


def read(ctx):
    return spans.idle_ms(ctx, lambda name: name.startswith(PREFIXES))
