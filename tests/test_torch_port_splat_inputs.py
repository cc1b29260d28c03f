"""The splat-input layer (projection, SH colours, opacities) vs the JAX chain (CPU).

``ops.splat_inputs_cuda`` runs the layer as one forward kernel S1 and its
analytic backward S2; on CPU tensors their plain versions run, and these
tests hold them against the JAX package's chain (``project_gaussians``,
``eval_sh``, the +0.5 shift and clamp, sigmoid, ``antialias_compensation``:
``tinysplat_tpu/render.py:139-169``) and against torch autograd of the plain
forward. A few hundred splats at 48x64, SH degree 3 stored, drawn with numpy
from a seed; torch on one thread.

Tolerances (the reference suite's, ROADMAP.md): outputs to 2e-4 (xys to
1e-4 + 1e-5 relative, as the render tests), radii, tile counts and valid
exactly; gradients normalised by their max to 5e-4 against ``jax.vjp`` and
to 1e-5 against autograd (the same chain rule, summed in another order).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.cameras import CameraParams as JaxCameraParams
from tinysplat_tpu.ops import projection as jproj
from tinysplat_tpu.ops import sh as jsh

from tinysplat_torch.render import splat_inputs
from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.ops import splat_inputs_cuda as si

from tests._torch_threads import one_torch_thread  # noqa: F401

# the module (the package's ``render`` attribute is the function)
jrender = importlib.import_module("tinysplat_tpu.render")

H, W, N, K = 48, 64, 320, 16
INPUTS = ("means", "scales", "quats", "colors_dc", "colors_rest", "opacities")
CAMERA = ("viewmat", "full_projmat", "cam_pos")
OUTPUTS = ("xys", "depths", "conics", "colors4", "opacities")
CX_OFF, CY_OFF = 1.5, -2.25
# Edge rows of the edge scene (indices into its N splats).
BEHIND, FOV, ZERO_QUAT, SH_TIE, NAN_OPACITY, NEEDLES, NEAR_ZERO = (
    [0, 1], [2, 3], [4], [5], [6], list(range(10, 40)), [7])


def _camera():
    cam = orbit_cameras(3, width=W, height=H)[1].params(device="cpu")
    view = cam.viewmat.numpy()
    return {"viewmat": view, "full_projmat": (cam.projmat @ cam.viewmat).numpy(),
            "cam_pos": cam.cam_pos.numpy(), "fx": float(cam.fx), "fy": float(cam.fy)}


def _scene(seed=3):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "means": rng.normal(0.0, 0.8, (N, 3)).astype(f32),
        "scales": rng.uniform(-4.0, -1.5, (N, 3)).astype(f32),
        "quats": rng.normal(size=(N, 4)).astype(f32),
        "colors_dc": rng.normal(0.0, 1.0, (N, 3)).astype(f32),
        "colors_rest": rng.normal(0.0, 0.3, (N, K - 1, 3)).astype(f32),
        "opacities": rng.normal(0.0, 2.0, (N, 1)).astype(f32),
    }


def _world(cam, p_cam):
    """World points whose camera-space coordinates are ``p_cam``."""
    view = cam["viewmat"].astype(np.float64)
    return ((np.asarray(p_cam, np.float64) - view[:3, 3]) @ view[:3, :3]).astype(np.float32)


def _tie_dc():
    """A DC coefficient whose float32 SH colour is exactly -0.5."""
    c0 = np.float32(jsh.SH_C0)
    dc = np.float32(-0.5 / jsh.SH_C0)
    while c0 * dc != np.float32(-0.5):
        dc = np.nextafter(dc, np.float32(0.0) if c0 * dc < -0.5 else np.float32(-1.0))
    return dc


def _edge_scene(fragile: bool):
    """The base scene with edge splats in its first rows: behind the near
    plane and behind the camera, past the fov clamp, a zero quaternion, an SH
    colour exactly at the clamp (rest coefficients 0, active degree 1), a
    NaN opacity. ``fragile`` adds splats whose branches fall by rounding:
    needles (one axis ~1e5 the others ~1e-4) whose 2D determinant cancels to
    <= 0 about half the time, and a splat at camera z ~ 0."""
    cam, p = _camera(), _scene(seed=5)
    tan_x = 0.5 * W / cam["fx"]
    p["means"][BEHIND] = _world(cam, [[0.1, 0.1, 0.005], [0.2, -0.1, -0.5]])
    p["means"][FOV] = _world(cam, [[3.0 * tan_x * 2.0, 0.2, 2.0], [0.1, -5.0, 1.5]])
    p["quats"][ZERO_QUAT] = 0.0
    p["colors_dc"][SH_TIE] = _tie_dc()
    p["colors_rest"][SH_TIE] = 0.0
    p["opacities"][NAN_OPACITY] = np.nan
    if fragile:
        rng = np.random.default_rng(9)
        p["scales"][NEEDLES] = np.log(np.stack(
            [np.full(len(NEEDLES), 1e5), np.full(len(NEEDLES), 1e-4),
             np.full(len(NEEDLES), 1e-4)], axis=1)).astype(np.float32)
        p["quats"][NEEDLES] = rng.normal(size=(len(NEEDLES), 4)).astype(np.float32)
        p["means"][NEEDLES] = _world(cam, np.stack(
            [rng.uniform(-0.5, 0.5, len(NEEDLES)), rng.uniform(-0.5, 0.5, len(NEEDLES)),
             rng.uniform(2.0, 3.0, len(NEEDLES))], axis=1))
        p["means"][NEAR_ZERO] = _world(cam, [[0.3, 0.2, 1e-9]])
    return cam, p


def _cotangents(seed=17):
    rng = np.random.default_rng(seed)
    shapes = {"xys": (N, 2), "depths": (N,), "conics": (N, 3), "colors4": (N, 4),
              "opacities": (N,)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@functools.cache
def _jax_chain(mode: str, antialiased: bool, fx: float, fy: float):
    """The JAX package's chain as one jitted function of the nine inputs:
    (outputs, integer outputs, vjp at the cotangents)."""

    def chain(deg, means, scales, quats, dc, rest, logits, viewmat, full_projmat, cam_pos):
        proj = jproj.project_gaussians(
            means=means, scales=jnp.exp(scales), glob_scale=1.0, quats=quats,
            viewmat=viewmat, full_projmat=full_projmat, fx=fx, fy=fy,
            cx=W / 2.0 + CX_OFF, cy=H / 2.0 + CY_OFF, img_height=H, img_width=W)
        cam = JaxCameraParams(viewmat, jnp.eye(4), cam_pos, fx, fy, CX_OFF, CY_OFF)
        dirs = jrender.compute_viewdirs(means, cam, mode)
        coeffs = jnp.concatenate([dc[:, None, :], rest], axis=1)
        rgbs = jnp.maximum(jsh.eval_sh(deg, dirs, coeffs) + 0.5, 0.0)
        opac = jax.nn.sigmoid(logits.reshape(-1))
        if antialiased:
            opac = opac * jrender.antialias_compensation(proj.conics)
        colors4 = jnp.concatenate([rgbs, proj.depths[:, None]], axis=-1)
        return ((proj.xys, proj.depths, proj.conics, colors4, opac),
                (proj.radii, proj.num_tiles_hit, proj.valid))

    @jax.jit
    def run(deg, args, cot):
        out, vjp, ints = jax.vjp(lambda *a: chain(deg, *a), *args, has_aux=True)
        return out, ints, vjp(cot)

    return run


def _jax(cam, p, mode, antialiased, deg, cot):
    run = _jax_chain(mode, antialiased, cam["fx"], cam["fy"])
    args = tuple(jnp.asarray(p[k]) for k in INPUTS) + tuple(jnp.asarray(cam[k]) for k in CAMERA)
    out, ints, grads = run(jnp.int32(deg), args, tuple(jnp.asarray(cot[k]) for k in OUTPUTS))
    return ([np.asarray(x) for x in out], [np.asarray(x) for x in ints],
            dict(zip(INPUTS + CAMERA, (np.asarray(g) for g in grads))))


def _torch(cam, p, mode, antialiased, deg, cot, fn):
    """``fn`` (``si.fused_splat_inputs`` or ``si.splat_fwd_plain``) on
    leaves that require grad; returns (outputs, gradients)."""
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    camt = {k: torch.tensor(cam[k], requires_grad=True) for k in CAMERA}
    layout = si.SplatLayout(W, H, 16, mode, antialiased)
    out = fn(*(leaves[k] for k in INPUTS), torch.ones(N, dtype=torch.bool),
             *(camt[k] for k in CAMERA), torch.tensor(cam["fx"]), torch.tensor(cam["fy"]),
             torch.tensor(CX_OFF), torch.tensor(CY_OFF), deg, layout)
    loss = sum((getattr(out, k) * torch.from_numpy(cot[k])).sum() for k in OUTPUTS)
    loss.backward()
    grads = {k: np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
             for k, t in {**leaves, **camt}.items()}  # None: the input was not used
    return out, grads


def _assert_grads_close(got, ref, tol, label):
    """Each gradient to ``tol`` x its max |ref|; NaNs where ref has them."""
    for k in INPUTS + CAMERA:
        a, b = got[k], ref[k]
        nan = np.isnan(b)
        np.testing.assert_array_equal(np.isnan(a), nan, err_msg=f"{label} {k}: NaN pattern")
        if nan.all():
            continue
        scale = max(float(np.abs(b[~nan]).max()), 1e-30)
        err = float(np.abs(a[~nan] - b[~nan]).max()) / scale
        assert err <= tol, f"{label} {k}: {err:.3e} of max > {tol:g}"


@pytest.mark.parametrize("deg", [3, 1, 0])
@pytest.mark.parametrize("mode,antialiased", [("reference", False), ("position", False),
                                              ("reference", True), ("position", True)])
def test_plain_forward_matches_jax(mode, antialiased, deg):
    cam, p, cot = _camera(), _scene(), _cotangents()
    (xys, depths, conics, colors4, opac), (radii, hit, valid), _ = _jax(
        cam, p, mode, antialiased, deg, cot)
    with torch.no_grad():
        out = si.splat_fwd(*(torch.from_numpy(p[k]) for k in INPUTS),
                           torch.ones(N, dtype=torch.bool),
                           *(torch.from_numpy(cam[k]) for k in CAMERA), cam["fx"], cam["fy"],
                           CX_OFF, CY_OFF, deg, si.SplatLayout(W, H, 16, mode, antialiased))
    np.testing.assert_allclose(out.xys.numpy(), xys, atol=1e-4, rtol=1e-5)
    for name, got, ref in (("depths", out.depths, depths), ("conics", out.conics, conics),
                           ("colors4", out.colors4, colors4), ("opacities", out.opacities, opac)):
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, err_msg=name)
    np.testing.assert_array_equal(out.radii.numpy(), radii)
    np.testing.assert_array_equal(out.num_tiles_hit.numpy(), hit)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    assert valid.sum() > N // 4 and (hit > 1).any()  # a real scene was compared
    assert out.radii.dtype == out.num_tiles_hit.dtype == torch.int32


@pytest.mark.parametrize("mode,antialiased", [("reference", False), ("position", False),
                                              ("reference", True), ("position", True)])
def test_plain_backward_matches_jax_and_autograd(mode, antialiased):
    cam, p, cot = _camera(), _scene(), _cotangents()
    _, _, g_jax = _jax(cam, p, mode, antialiased, 3, cot)
    out, g_fused = _torch(cam, p, mode, antialiased, 3, cot, si.fused_splat_inputs)
    _, g_auto = _torch(cam, p, mode, antialiased, 3, cot, si.splat_fwd_plain)
    assert type(out.xys.grad_fn).__name__ == "_FusedSplatInputsBackward"
    _assert_grads_close(g_fused, g_auto, 1e-5, "vs autograd")
    _assert_grads_close(g_fused, g_jax, 5e-4, "vs jax.vjp")
    if mode == "reference":  # the view origin is viewmat's translation
        assert not g_fused["cam_pos"].any()


@pytest.mark.parametrize("antialiased", [False, True])
@pytest.mark.parametrize("fragile", [False, True])
def test_edge_splats(fragile, antialiased):
    """Stored degree 3, active degree 1. The edges hold autograd's gradient;
    without the fragile splats they hold JAX's too (with them, which side of
    a cancelled determinant or of |z| < 1e-8 a splat lands on is decided by
    rounding, which XLA and torch do differently)."""
    cam, p = _edge_scene(fragile)
    cot = _cotangents(seed=23)
    out, g_fused = _torch(cam, p, "reference", antialiased, 1, cot, si.fused_splat_inputs)
    _, g_auto = _torch(cam, p, "reference", antialiased, 1, cot, si.splat_fwd_plain)
    _assert_grads_close(g_fused, g_auto, 1e-5, "vs autograd")
    valid = out.valid.numpy()
    assert not valid[BEHIND].any() and valid[FOV].all()
    assert (out.colors4[SH_TIE, :3] == 0).all()  # exactly at the clamp
    # half of the tie's gradient reaches its DC coefficient
    c0 = np.float32(jsh.SH_C0)
    np.testing.assert_allclose(g_fused["colors_dc"][SH_TIE], 0.5 * c0 * cot["colors4"][SH_TIE, :3],
                               rtol=1e-6)
    assert np.isnan(g_fused["opacities"][NAN_OPACITY]).all()
    assert np.isfinite(g_fused["quats"][ZERO_QUAT]).all()
    assert not g_fused["colors_rest"][:, 3:].any()  # bands above degree 1 get nothing
    if fragile:
        det_le_0 = ~valid[NEEDLES]
        assert det_le_0.any() and not det_le_0.all(), "needles on both sides of det = 0"
        finite = [k for k in INPUTS if k != "opacities"]
        for k in finite:
            rows = np.delete(g_fused[k], NAN_OPACITY, axis=0)
            assert np.isfinite(rows).all(), k
    else:
        _, _, g_jax = _jax(cam, p, "reference", antialiased, 1, cot)
        _assert_grads_close(g_fused, g_jax, 5e-4, "vs jax.vjp")


@pytest.mark.parametrize("name", ["fx", "fy", "cx_off", "cy_off"])
def test_differentiable_intrinsics_raise(name):
    cam, p = _camera(), _scene()
    intr = {"fx": torch.tensor(cam["fx"]), "fy": torch.tensor(cam["fy"]),
            "cx_off": torch.tensor(CX_OFF), "cy_off": torch.tensor(CY_OFF)}
    intr[name].requires_grad_()
    with pytest.raises(ValueError, match=name):
        si.fused_splat_inputs(*(torch.from_numpy(p[k]) for k in INPUTS),
                              torch.ones(N, dtype=torch.bool),
                              *(torch.from_numpy(cam[k]) for k in CAMERA), *intr.values(), 3,
                              si.SplatLayout(W, H))


def test_splat_inputs_runs_the_function_and_refuses_other_devices():
    from tinysplat_torch.models.gaussians import GaussianParams

    p = _scene()
    params = GaussianParams(**{k: torch.tensor(v, requires_grad=True) for k, v in p.items()})
    camp = orbit_cameras(3, width=W, height=H)[1].params(device="cpu")
    s = splat_inputs(params, torch.ones(N, dtype=torch.bool), camp, H, W, 3, torch.zeros(3),
                     xys_probe=torch.zeros((N, 2), requires_grad=True))
    assert type(s.colors4.grad_fn).__name__ == "_FusedSplatInputsBackward"
    assert s.proj.radii.dtype == torch.int32 and not s.proj.radii.requires_grad
    meta = torch.empty((N, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        si.splat_fwd(meta, meta, torch.empty((N, 4), device="meta"), meta,
                     torch.empty((N, K - 1, 3), device="meta"),
                     torch.empty((N, 1), device="meta"),
                     torch.ones(N, dtype=torch.bool, device="meta"),
                     torch.empty((4, 4), device="meta"), torch.empty((4, 4), device="meta"),
                     torch.empty(3, device="meta"), 1.0, 1.0, 0.0, 0.0, 3,
                     si.SplatLayout(W, H))
