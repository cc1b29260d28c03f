"""On the card only (skipped elsewhere): the control, the reference in
TF32, fails the cell's limits, at a size a test run holds."""
import pytest

from splatbench import spec

pytestmark = pytest.mark.cuda


def small(name):
    c = spec.cell(name)
    cfg = dict(c.config, n_splats=65536, capacity=65536, height=528, width=800)
    return c._replace(config=cfg)


@pytest.mark.parametrize("name", ["train.splats-262k", "serve.splats-1m", "train.splats-1m"])
def test_control_fails_the_limits(card, name):
    cell = small(name)
    out = spec.kind(cell.traffic["kind"]).control(cell, 20260101, card)
    assert any(v > cell.limits[k] for k, v in out.items()), out
