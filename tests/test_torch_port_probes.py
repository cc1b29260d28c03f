"""The probes' plain versions vs the JAX probes (``scripts/probe_*.py``,
loaded by path; their Pallas kernels run in interpret mode, as the scripts
themselves do off the TPU).

P1: variants A, B, D, E and F equal the JAX kernels bit for bit. C is
compared with the numpy ground truth only: the JAX interpret path quiets
f32 halves that form bf16 NaN patterns (scripts/probe_bf16_bitcast.py:22-26),
while the port moves u16 bits as integers; JAX's C result is recorded, not
asserted.

P2: each elementwise row against the JAX ``_probe_kernel`` on the same
input, within ``TOLERANCE`` below; the triangular ladder against the jnp
expressions of ``_tri_kern`` (scripts/probe_vpu_costs.py:71-95) copied
here, with DEFAULT precision written out as one bf16 pass (what it is on
the TPU's matrix unit; XLA:CPU would keep f32).
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tinysplat_torch.probes import bitcast, op_costs

from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def jax_p1():
    return _load("probe_bf16_bitcast")


@functools.cache
def jax_p2():
    return _load("probe_vpu_costs")


# -- P1 ----------------------------------------------------------------------------


def _jax_variant(variant, gt):
    m = jax_p1()
    S, L = m.S, m.L
    f32, bf16, u16 = jnp.float32, jnp.bfloat16, jnp.uint16
    if variant in "ABC":
        kern = {"A": m._kernel_a, "B": m._kernel_b, "C": m._kernel_c}[variant]
        inp = gt["pairs"] if variant in "AB" else gt["halves"]
        out = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((S, L), f32),
                             interpret=True)(jnp.asarray(inp).view(bf16))
        return np.asarray(out)
    if variant == "D":
        out, col = pl.pallas_call(
            m._kernel_d, out_shape=(jax.ShapeDtypeStruct((S, L), f32),
                                    jax.ShapeDtypeStruct((S, L), bf16)),
            interpret=True)(jnp.asarray(gt["halves"]))
        return np.asarray(out), np.asarray(col)
    if variant == "E":
        return np.asarray(pl.pallas_call(
            m._kernel_e, out_shape=jax.ShapeDtypeStruct((S, 2 * L), u16),
            interpret=True)(jnp.asarray(gt["f32"])))
    # F: kern_f of scripts/probe_bf16_bitcast.py:134-158, copied (it is a
    # closure of the script's main()).
    from jax.experimental.pallas import tpu as pltpu

    N, CH = bitcast.WINDOW_SRC[0], bitcast.WINDOW_ROWS

    def kern_f(off_ref, src_ref, o_ref, buf, sem):
        cp = pltpu.make_async_copy(src_ref.at[pl.ds(off_ref[0], CH), :], buf, sem)
        cp.start()
        cp.wait()
        o_ref[...] = buf[...]

    fn = pl.pallas_call(
        kern_f,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((CH, 128), lambda g, s: (0, 0)),
            scratch_shapes=[pltpu.VMEM((CH, 128), u16), pltpu.SemaphoreType.DMA]),
        out_shape=jax.ShapeDtypeStruct((CH, 128), u16), interpret=True)
    src = jnp.arange(N * 128, dtype=jnp.uint32).astype(u16).reshape(N, 128)
    return np.stack([np.asarray(fn(jnp.asarray([o], jnp.int32), src))
                     for o in bitcast.WINDOW_OFFSETS])


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16 if x.element_size() == 2 else torch.int32).numpy()
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def test_p1_ground_truth_is_the_jax_probes():
    m = jax_p1()
    gt = bitcast.ground_truth()
    assert (bitcast.S, bitcast.L) == (m.S, m.L)
    rng = np.random.default_rng(0)  # the JAX probe's draw, main():84-93
    f32 = (rng.normal(size=(m.S, m.L)).astype(np.float32)
           * np.exp2(rng.integers(-20, 20, size=(m.S, m.L))).astype(np.float32))
    np.testing.assert_array_equal(gt["f32"].view(np.uint32), f32.view(np.uint32))


@pytest.mark.parametrize("variant", ["A", "B", "D", "E", "F"])
def test_p1_plain_matches_jax_bit_for_bit(variant):
    gt = bitcast.ground_truth()
    got = bitcast.probe_bitcast(variant, bitcast.variant_input(variant, gt, "cpu"))
    assert bitcast.exact(variant, got, gt)
    ref = _jax_variant(variant, gt)
    if variant == "D":
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(_bits(g), _bits(r))
    else:
        np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_p1_variant_c_exact_in_the_port(record_property):
    gt = bitcast.ground_truth()
    got = bitcast.probe_bitcast("C", bitcast.variant_input("C", gt, "cpu"))
    assert bitcast.exact("C", got, gt)
    jax_exact = bool(np.array_equal(_jax_variant("C", gt).view(np.uint32), gt["u32"]))
    record_property("jax_interpret_variant_c_exact", jax_exact)


def test_p1_wrapper_checks():
    x = torch.zeros((4, 6), dtype=torch.float32)
    with pytest.raises(TypeError, match="int16"):
        bitcast.probe_bitcast("A", x)
    with pytest.raises(ValueError, match="variant"):
        bitcast.probe_bitcast("G", x)
    with pytest.raises(ValueError, match="8 u16 lanes"):
        bitcast.probe_bitcast("F", torch.zeros((64, 12), dtype=torch.int16))
    with pytest.raises(ValueError, match="multiple of 8 f32 lanes"):
        bitcast.probe_bitcast("C", torch.zeros((4, 12), dtype=torch.int16))
    with pytest.raises(ValueError, match="multiple of 8 f32 lanes"):
        bitcast.probe_bitcast("E", torch.zeros((4, 12), dtype=torch.float32))
    # F clamps offsets to the source, in the plain version as in the kernel.
    src = torch.arange(64 * 8, dtype=torch.int16).reshape(64, 8)
    out = bitcast.probe_bitcast("F", src, bitcast.window_offsets([-5, 40], "cpu"))
    assert torch.equal(out[0], src[0:32]) and torch.equal(out[1], src[32:64])


# -- P2 ----------------------------------------------------------------------------

# Port plain vs JAX interpret, as max|port - jax| / max|jax|. Divisions,
# compares and min round alike in both (0). XLA:CPU rewrites the rest:
# it folds mul2's two constant factors into one product and fuses
# multiply-adds (fma, bf16_split), one rounding where the port has two,
# over 512 iterations that do not contract (1e-4; bf16_split's fused term
# is 1e-8 x small, 1e-6); it computes exp, exp2 and log2 with its own
# approximations, within a few ulps of libm's, on contractive maps (1e-6).
TOLERANCE = {"fma": 1e-4, "mul2": 1e-4, "bf16_split": 1e-6, "exp": 1e-6, "exp2": 1e-6,
             "log2": 1e-6}
ELEMENTWISE = [op for op in op_costs.OPS if op not in op_costs.TRI]


@functools.cache
def _x0():
    m = jax_p2()
    return np.asarray(jnp.linspace(0.1, 1.9, m.S * m.L, dtype=jnp.float32).reshape(m.S, m.L))


def test_p2_constants_match_the_jax_probe():
    m = jax_p2()
    assert (op_costs.S, op_costs.ITERS, op_costs.CHAINS) == (m.S, m.ITERS, m.CHAINS)
    assert op_costs.OPS == tuple(m.OPS)


@pytest.mark.parametrize("op", ELEMENTWISE)
def test_p2_plain_rows_match_jax(op):
    m = jax_p2()
    fn = pl.pallas_call(functools.partial(m._probe_kernel, m.OPS[op]),
                        out_shape=jax.ShapeDtypeStruct((m.S, m.L), jnp.float32),
                        interpret=True)
    ref = np.asarray(jax.jit(fn)(jnp.asarray(_x0())))
    got = op_costs.probe_op_costs(op, torch.from_numpy(_x0().copy())).numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOLERANCE.get(op, 0.0), (op, err)


def _jax_tri(mode, x, iters):
    """_tri_kern's jnp expressions (scripts/probe_vpu_costs.py:71-95), with
    DEFAULT as one bf16 pass."""
    S = x.shape[0]
    tri = (jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
           <= jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)).astype(jnp.float32)

    def d(a, b):
        return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32,
                                   precision=jax.lax.Precision.HIGHEST)

    def mm(x):
        t16 = tri.astype(jnp.bfloat16).astype(jnp.float32)
        if mode == "x2":
            hi = x.astype(jnp.bfloat16)
            lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
            return d(t16, hi.astype(jnp.float32)) + d(t16, lo.astype(jnp.float32))
        if mode == "highest":
            return d(tri, x)
        return d(t16, x.astype(jnp.bfloat16).astype(jnp.float32))

    return np.asarray(jax.lax.fori_loop(0, iters, lambda i, x: mm(x) * 1e-3, x))


@pytest.mark.parametrize("op,mode", [("tri_matmul", "default"), ("tri_highest", "highest"),
                                     ("tri_x2_manual", "x2")])
def test_p2_ladder_matches_the_jnp_expressions(op, mode):
    x = _x0()
    for iters in (1, 2, op_costs.ITERS):
        ref = _jax_tri(mode, jnp.asarray(x), iters)
        got = op_costs.probe_op_costs(op, torch.from_numpy(x.copy()), iters).numpy()
        scale = max(np.abs(ref).max(), 1e-30)
        assert np.abs(got - ref).max() / scale <= 1e-5, (op, iters)
    assert np.abs(got).max() == 0.0  # 512 passes of x 1e-3 underflow to 0


def test_p2_wrapper_checks_and_bounds():
    with pytest.raises(ValueError, match="op"):
        op_costs.probe_op_costs("sqrt", torch.zeros((128, 64)))
    with pytest.raises(ValueError, match="L % 64"):
        op_costs.probe_op_costs("tri_matmul", torch.zeros((128, 96)))
    with pytest.raises(TypeError, match="float32"):
        op_costs.probe_op_costs("fma", torch.zeros((128, 64), dtype=torch.float64))
    # fma at 132 SMs x 1980 MHz: 128 x L x 512 x 4 FFMA at 128 a clock per SM.
    b = op_costs.bound_ms("fma", 33792, 132, 1.98e9)
    np.testing.assert_allclose(b, 128 * 33792 * 512 * 4 / 128 / (132 * 1.98e9) * 1e3)
    assert op_costs.bound_ms("exp", 256, 132, 1.98e9) == 8 * op_costs.bound_ms(
        "exp2", 256, 132, 1.98e9) / 8
