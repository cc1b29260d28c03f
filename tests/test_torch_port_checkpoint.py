"""Checkpoints across the packages: the JAX package writes and the port
loads, and the port writes and the JAX package's ``load_checkpoint`` loads.

State, Adam moments, count, step and extras must be equal (exactly: both
sides copy float32 arrays). The leaf orders the port writes are pinned here
by flattening real JAX objects.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.io import checkpoint as jck

from tinysplat_torch.config import Config
from tinysplat_torch.io import checkpoint as tck
from tinysplat_torch.models.gaussians import PARAM_FIELDS

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_port_densify import jax_pair, make_arrays, torch_pair

EXTRAS = {"pose_deltas": np.arange(12, dtype=np.float32).reshape(2, 6),
          "pose_cnt": np.asarray([3, 4], np.int32)}


def test_leaf_orders_match_jax_flatten():
    a = make_arrays(seed=1)
    js, jo = jax_pair(a)
    ts, to = torch_pair(a)
    jstate = jax.tree.leaves(js)
    assert len(jstate) == len(tck.STATE_LEAVES)
    for got, ref in zip(tck.state_leaves(ts), jstate):
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    jopt = jax.tree.leaves(jo)
    assert len(jopt) == tck.N_OPT_LEAVES
    for got, ref in zip(tck.opt_leaves(to), jopt):
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def _assert_states_equal(ts, to, js, jo):
    for got, ref in zip(tck.state_leaves(ts), jax.tree.leaves(js)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    for got, ref in zip(tck.opt_leaves(to), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_jax_writes_port_loads(tmp_path):
    a = make_arrays(seed=2, count=7)
    js, jo = jax_pair(a)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, js, jo, step=42, rng_key=jax.random.PRNGKey(1), extras=EXTRAS)
    ts, to, step, rng = tck.load_checkpoint(path, Config(), device="cpu")
    assert step == 42 and rng is None and to.count == 7
    assert all(g["params"][0] is t for g, (_, t) in zip(to.param_groups, ts.params.fields()))
    _assert_states_equal(ts, to, js, jo)
    extras = tck.load_checkpoint_extras(path)
    assert set(extras) == set(EXTRAS)
    for k, v in EXTRAS.items():
        np.testing.assert_array_equal(extras[k], v)
    # The model keys serve from either package.
    model = tck.load_model(path, device="cpu")
    assert int(model.alive.sum()) == int(a["alive"].sum())


def test_port_writes_jax_loads(tmp_path):
    a = make_arrays(seed=3, count=5)
    js, jo = jax_pair(a)
    ts, to = torch_pair(a)
    gen = torch.Generator().manual_seed(9)
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, ts, to, step=17, rng_state=gen.get_state(), extras=EXTRAS)
    jstate, jopt, step, key = jck.load_checkpoint(path, JaxConfig())
    assert step == 17 and key is None  # the port's generator state is its own key
    for got, ref in zip(jax.tree.leaves(jstate), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert np.asarray(got).dtype == np.asarray(ref).dtype
    for got, ref in zip(jax.tree.leaves(jopt), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert np.asarray(got).dtype == np.asarray(ref).dtype
    extras = jck.load_checkpoint_extras(path)
    for k, v in EXTRAS.items():
        np.testing.assert_array_equal(extras[k], v)
    # And back into the port, generator state included.
    ts2, to2, step2, rng = tck.load_checkpoint(path, Config(), device="cpu")
    assert step2 == 17 and torch.equal(rng, gen.get_state())
    _assert_states_equal(ts2, to2, js, jo)
    # The JAX package's model-only load reads the port's model keys.
    model = jck.load_model(path)
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(model.params, k))[:int(a["alive"].sum())],
                                      a[k][a["alive"]])


def test_checkpoint_without_optimizer_and_unstepped_optimizer(tmp_path):
    a = make_arrays(seed=4)
    ts, _ = torch_pair(a)
    path = str(tmp_path / "noopt.npz")
    tck.save_checkpoint(path, ts, None, step=1)
    _, opt, _, _ = tck.load_checkpoint(path, Config(), device="cpu")
    assert opt is None
    # A fresh optimizer writes zero moments and count 0, as optax's init does.
    from tinysplat_torch.train import init_opt_state

    ts2, _ = torch_pair(a)
    tck.save_checkpoint(path, ts2, init_opt_state(Config(), ts2), step=0)
    _, jopt, _, _ = jck.load_checkpoint(path, JaxConfig())
    leaves = jax.tree.leaves(jopt)
    assert int(leaves[0]) == 0 and int(leaves[-1]) == 0
    assert all(float(jnp.abs(x).sum()) == 0.0 for x in leaves[1:-1])
