"""SuGaR's density term's dispatch to its kernels (``ops/density_cuda``) and
the kernels' wrappers, on the CPU. The kernels themselves run on the card
only (``tests/test_torch_port_cuda.py``).

- CPU tensors, with a camera that carries a gradient (``pose_opt``) or
  not, take the plain torch ops of ``density_loss``: the same loss and
  gradients as those ops written out here, and no launch.
- On the card (faked here: ``density_cuda._on_card``) every call takes the
  kernels, a camera carrying a gradient too; a tensor of another type
  raises there and runs no torch op of the term.
- The wrappers refuse, before any launch, what the kernels do not take:
  dtypes, shapes, contiguity, a quaternion table off a 16-byte boundary,
  tensors on two devices, and CPU tensors.
"""
import dataclasses

import pytest
import torch

from tinysplat_torch.cameras import apply_pose_delta
from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.models.gaussians import GaussianParams
from tinysplat_torch.ops import _build
from tinysplat_torch.ops import density_cuda as dc
from tinysplat_torch.regularizers import density as pd

from tests._torch_threads import one_torch_thread  # noqa: F401

N, S, H, W = 300, 40, 24, 32


def case(seed=0):
    """(probe, params, depth map, camera) of N random splats and S points
    drawn from them, seen by an orbit camera."""
    g = torch.Generator().manual_seed(seed)
    means = torch.rand((N, 3), generator=g) * 2 - 1
    zeros = torch.zeros_like(means)
    params = GaussianParams(means=means, colors_dc=zeros, colors_rest=zeros[:, None],
                            scales=torch.rand((N, 3), generator=g) * 2.3 - 3.9,
                            quats=torch.randn((N, 4), generator=g),
                            opacities=torch.randn((N, 1), generator=g))
    alive = torch.ones(N, dtype=torch.bool)
    points, _ = pd.sample_points(params, alive, S, generator=g)
    probe = pd.DensityProbe(points, pd.knn_indices(points, means, alive, k=16), None)
    cam = orbit_cameras(1, width=W, height=H)[0].params("cpu")
    z = (points @ cam.viewmat[:3, :3].T + cam.viewmat[:3, 3])[:, 2]
    depth = z.mean() + 0.05 * torch.randn((H, W), generator=g)
    return probe, params, depth, cam


def with_grad(params, depth):
    leaves = {k: getattr(params, k).detach().clone().requires_grad_()
              for k in ("means", "quats", "scales", "opacities")}
    return dataclasses.replace(params, **leaves), depth.detach().clone().requires_grad_()


def written_out(probe, params, depth, cam, use_sdf):
    """The plain term, its ops written out from ``density_loss``'s pieces."""
    d = pd.density_at_points(probe.points, probe.knn_idx, params)
    beta = pd.probe_beta(params, probe.knn_idx)
    est, mask = pd.approximate_density(probe.points, depth, cam, beta, H, W, return_sdf=use_sdf)
    if use_sdf:
        err = torch.abs(beta * torch.sqrt(-2.0 * torch.log(torch.clamp(d, 0.001, 0.999))) - est)
    else:
        err = torch.abs(d - est)
    return torch.where(mask, err, 0.0).sum() / torch.clamp(mask.float().sum(), min=1.0)


def term_and_grads(fn, probe, params, depth, cam, use_sdf):
    params, depth = with_grad(params, depth)
    loss = fn(probe, params, depth, cam, use_sdf)
    leaves = [params.means, params.quats, params.scales, params.opacities, depth]
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


def density_loss(probe, params, depth, cam, use_sdf):
    return pd.density_loss(probe, params, depth, cam, H, W, use_sdf=use_sdf)


def refuse_fused(*args, **kwargs):
    raise AssertionError("the kernels' path was taken")


def refuse_plain(*args, **kwargs):
    raise AssertionError("the plain path was taken")


@pytest.fixture
def no_launch():
    """Fails the test if a kernel was launched."""
    before = dict(_build.launches)
    yield
    assert dict(_build.launches) == before


@pytest.mark.parametrize("use_sdf", [False, True])
def test_cpu_tensors_take_the_plain_ops(monkeypatch, no_launch, use_sdf):
    monkeypatch.setattr(dc, "fused_density_loss", refuse_fused)
    probe, params, depth, cam = case()
    assert not dc.takes_kernels(probe, params, depth, cam)
    got, got_g = term_and_grads(density_loss, probe, params, depth, cam, use_sdf)
    want, want_g = term_and_grads(written_out, probe, params, depth, cam, use_sdf)
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_sdf", [False, True])
def test_a_camera_carrying_gradient_takes_the_plain_ops_on_the_cpu(monkeypatch, no_launch,
                                                                    use_sdf):
    """``pose_opt``'s camera on the CPU: the torch ops, and the pose delta
    gets its gradient."""
    monkeypatch.setattr(dc, "fused_density_loss", refuse_fused)
    probe, params, depth, cam = case(1)
    delta = torch.full((6,), 1e-3, requires_grad=True)
    posed = apply_pose_delta(cam, delta)
    assert not dc.takes_kernels(probe, params, depth, posed)
    loss = density_loss(probe, params, depth, posed, use_sdf)
    (g,) = torch.autograd.grad(loss, [delta])
    assert torch.equal(loss, written_out(probe, params, depth, posed, use_sdf))
    assert bool(g.any())


@pytest.mark.parametrize("use_sdf", [False, True])
def test_a_camera_carrying_gradient_takes_the_kernels_on_the_card(monkeypatch, use_sdf):
    """``pose_opt``'s camera on the card: the kernels, which give the
    camera's gradient too."""
    monkeypatch.setattr(dc, "_on_card", lambda t: True)
    monkeypatch.setattr(pd, "density_at_points", refuse_plain)
    seen = []
    monkeypatch.setattr(dc, "fused_density_loss",
                        lambda *args: seen.append(args) or torch.zeros(()))
    probe, params, depth, cam = case(1)
    posed = apply_pose_delta(cam, torch.full((6,), 1e-3, requires_grad=True))
    assert dc.takes_kernels(probe, params, depth, posed)
    density_loss(probe, params, depth, posed, use_sdf)
    assert len(seen) == 1 and seen[0][3] is posed and seen[0][6] == use_sdf


def test_float32_on_the_card_takes_the_kernels(monkeypatch):
    monkeypatch.setattr(dc, "_on_card", lambda t: True)
    seen = []
    monkeypatch.setattr(dc, "fused_density_loss",
                        lambda *args: seen.append(args) or torch.zeros(()))
    probe, params, depth, cam = case(2)
    pd.density_loss(probe, params, depth, cam, H, W, use_sdf=True)
    assert len(seen) == 1 and seen[0][4:] == (H, W, True)


def _off(what):
    """A case's (probe, params, depth, camera) with one tensor changed."""
    probe, params, depth, cam = case(3)
    if what == "camera grad":
        cam = dataclasses.replace(cam, viewmat=cam.viewmat.clone().requires_grad_())
    elif what == "cx_off grad":
        cam = dataclasses.replace(cam, cx_off=cam.cx_off.clone().requires_grad_())
    elif what == "float64 means":
        params = dataclasses.replace(params, means=params.means.double())
    elif what == "float64 depth":
        depth = depth.double()
    elif what == "int32 indices":
        probe = probe._replace(knn_idx=probe.knn_idx.int())
    return probe, params, depth, cam


OFF = ["camera grad", "cx_off grad", "float64 means", "float64 depth", "int32 indices",
       "nothing"]


@pytest.mark.parametrize("what", OFF)
def test_takes_kernels_reads_the_device_alone(monkeypatch, what):
    """On the card every call takes the kernels, whatever its dtypes and
    gradients; on the CPU none does."""
    assert not dc.takes_kernels(*_off(what))
    monkeypatch.setattr(dc, "_on_card", lambda t: True)
    assert dc.takes_kernels(*_off(what))


def _term_tensors(probe, params, depth, cam):
    return (probe.points, probe.knn_idx, params.means, params.quats, params.scales,
            params.opacities, depth, cam.viewmat, cam.projmat, cam.cx_off, cam.cy_off)


@pytest.mark.parametrize("which", range(11))
def test_takes_kernels_reads_each_device(monkeypatch, which):
    """Any one of the term's tensors on the card takes the kernels, whose
    wrappers then refuse the two devices."""
    args = case(4)
    one = _term_tensors(*args)[which]
    monkeypatch.setattr(dc, "_on_card", lambda t: t is one)
    assert dc.takes_kernels(*args)


@pytest.mark.parametrize("what", ["float64 means", "float64 depth", "int32 indices"])
def test_another_dtype_on_the_card_raises(monkeypatch, no_launch, what):
    """On the card the term runs no torch op of its plain version: a tensor
    of another type is refused."""
    monkeypatch.setattr(dc, "_on_card", lambda t: True)
    monkeypatch.setattr(pd, "density_at_points", refuse_plain)
    with pytest.raises(TypeError):
        pd.density_loss(*_off(what), H, W)


def _inputs(what):
    """A case's ``TermInputs`` with one field made what the kernels refuse."""
    probe, params, depth, cam = case(5)
    t = dc.term_inputs(probe, params, depth, cam, H, W, False)
    changes = {
        "float64 points": dict(points=t.points.double()),
        "points of 4": dict(points=torch.zeros((S, 4))),
        "int32 indices": dict(knn_idx=t.knn_idx.int()),
        "indices of another count": dict(knn_idx=t.knn_idx[1:]),
        "no neighbours": dict(knn_idx=t.knn_idx[:, :0]),
        "strided indices": dict(knn_idx=torch.cat([t.knn_idx, t.knn_idx], 1)[:, ::2]),
        "float16 scales": dict(scales=t.scales.half()),
        "quats of 3": dict(quats=t.quats[:, :3].contiguous()),
        "opacities flat": dict(opacities=t.opacities[:, 0]),
        "means of another count": dict(means=t.means[1:]),
        "strided means": dict(means=torch.cat([t.means, t.means], 1)[:, ::2]),
        "quats off 16 bytes": dict(quats=torch.zeros(N * 4 + 1)[1:].view(N, 4)),
        "depth of 3 axes": dict(depth_map=t.depth_map[None]),
        "empty depth": dict(depth_map=t.depth_map[:0]),
        "viewmat 3x4": dict(viewmat=t.viewmat[:3].contiguous()),
        "transposed projmat": dict(projmat=t.projmat.T),
        "two cx_off": dict(cx_off=torch.zeros(2)),
        "int cy_off": dict(cy_off=torch.zeros((), dtype=torch.int32)),
        "depth on another device": dict(depth_map=torch.zeros((H, W), device="meta")),
        "on the CPU": {},
    }
    return t._replace(**changes[what])


REFUSED = {"float64 points": TypeError, "points of 4": ValueError, "int32 indices": TypeError,
           "indices of another count": ValueError, "no neighbours": ValueError,
           "strided indices": ValueError, "float16 scales": TypeError, "quats of 3": ValueError,
           "opacities flat": ValueError, "means of another count": ValueError,
           "strided means": ValueError, "quats off 16 bytes": ValueError,
           "depth of 3 axes": ValueError, "empty depth": ValueError, "viewmat 3x4": ValueError,
           "transposed projmat": ValueError, "two cx_off": ValueError, "int cy_off": TypeError,
           "depth on another device": ValueError, "on the CPU": ValueError}


@pytest.mark.parametrize("what", list(REFUSED))
def test_the_wrappers_refuse_what_the_kernels_do_not_take(no_launch, what):
    t = _inputs(what)
    one = torch.ones(())
    with pytest.raises(REFUSED[what]):
        dc.density_fwd(t)
    with pytest.raises(REFUSED[what]):
        dc.density_bwd(one, one, t)


@pytest.mark.parametrize("which", ["g", "denom"])
def test_the_backward_takes_one_float_upstream(monkeypatch, which):
    """``g`` and ``denom`` are read on the device as one float each."""
    monkeypatch.setattr(dc, "_check", lambda t: (S, 16, N))
    t = dc.term_inputs(*case(6), H, W, False)
    args = {"g": torch.ones(()), "denom": torch.ones(())}
    args[which] = torch.ones(2)
    with pytest.raises(ValueError, match=which):
        dc.density_bwd(args["g"], args["denom"], t)


def test_the_gradient_row_holds_each_field_once():
    """``splat_grads`` reads the (N, ROW) rows' columns by field, every
    column but the pad once."""
    rows = torch.arange(5 * dc.ROW, dtype=torch.float32).view(5, dc.ROW)
    grads = dc.splat_grads(rows)
    widths = dict(dc.SPLAT_FIELDS)
    cols = []
    for (name, _), g in zip((("means", 3), ("quats", 4), ("scales", 3), ("opacities", 1)),
                            grads):
        assert g.shape == (5, widths[name])
        cols += [int(c) for c in g[0]]
    assert sorted(cols) == list(range(dc.ROW - 1))


@pytest.fixture
def launches_recorded(monkeypatch):
    """The kernels' launches recorded, not made: (symbol, args) each; the
    checks pass CPU tensors."""
    seen = []
    monkeypatch.setattr(dc, "_check", lambda t: (t.points.shape[0], t.knn_idx.shape[1],
                                                 t.means.shape[0]))
    monkeypatch.setattr(_build, "launch",
                        lambda name, sig, dev, *args, symbol="": seen.append((symbol, args)))
    return seen


def test_the_camera_row_holds_each_field_once():
    """``camera_grads`` reads the camera row's fields in ``CAMERA``'s order,
    each in the shape of its camera tensor."""
    t = dc.term_inputs(*case(6), H, W, False)
    row = torch.arange(dc.CAM_ROW, dtype=torch.float32)
    grads = dc.camera_grads(row, t)
    assert [g.shape for g in grads] == [getattr(t, k).shape for k, _ in dc.CAMERA]
    assert torch.equal(torch.cat([g.reshape(-1) for g in grads]), row)
    assert sum(w for _, w in dc.CAMERA) == dc.CAM_ROW


@pytest.mark.parametrize("camera_grad", [False, True])
@pytest.mark.parametrize("depth_grad", [True, False])
def test_the_function_launches_once_each_way(launches_recorded, depth_grad, camera_grad):
    """One ``density_fwd`` a forward, one ``density_bwd`` a backward with a
    zeroed gradient of each leaf's shape; a depth map or camera without
    gradient is not asked for (null pointers)."""
    probe, params, depth, cam = case(7)
    params, depth = with_grad(params, depth)
    depth.requires_grad_(depth_grad)
    cam = dataclasses.replace(cam, viewmat=cam.viewmat.clone().requires_grad_(camera_grad),
                              cy_off=cam.cy_off.clone().requires_grad_(camera_grad))
    loss = dc.fused_density_loss(probe, params, depth, cam, H, W, True)
    leaves = ([params.means, params.quats, params.scales, params.opacities] + [depth] * depth_grad
              + [cam.viewmat, cam.cy_off] * camera_grad)
    grads = torch.autograd.grad(loss, leaves)
    assert [s for s, _ in launches_recorded] == ["density_fwd", "density_bwd"]
    assert [g.shape for g in grads] == [t.shape for t in leaves]
    assert not any(bool(g.any()) for g in grads)
    *_, depth_ptr, cam_part, cam_grad = launches_recorded[1][1]
    assert (depth_ptr is None) == (not depth_grad)
    assert (cam_part is None) == (cam_grad is None) == (not camera_grad)
    assert launches_recorded[0][1][20] == 1  # use_sdf


def test_the_backward_launches_inside_its_span(launches_recorded):
    """``density_bwd`` is launched inside ``ts.density.backward``, in its
    own operator range, where the benchmark's reader finds it."""
    probe, params, depth, cam = case(8)
    params, depth = with_grad(params, depth)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        dc.fused_density_loss(probe, params, depth, cam, H, W, False).backward()

    def under(e, name):
        while e is not None:
            if e.name == name:
                return True
            e = e.cpu_parent
        return False

    events = prof.events()
    assert [e.name for e in events if under(e, "ts.density.backward")
            and e.name.startswith("density_")] == ["density_bwd"]
    assert any(e.name == "density_fwd" for e in events)
