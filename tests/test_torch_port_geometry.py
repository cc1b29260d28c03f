"""Port vs JAX package: cameras, EWA projection and SH colours (CPU).

The same numpy inputs, made from a seed, go through both packages.
Tolerances: projected floats to 1e-5 (abs and rel; float32 rounding of the
same arithmetic in another order), radii and validity exactly, SH colours
to 1e-6.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.ops.projection import project_gaussians as jax_project
from tinysplat_tpu.ops.sh import eval_sh as jax_eval_sh
from tinysplat_tpu.utils.quaternions import quat_to_rotmat as jax_quat_to_rotmat

from tinysplat_torch.data.synthetic import orbit_cameras, random_gaussian_cloud
from tinysplat_torch.ops.projection import project_gaussians
from tinysplat_torch.ops.sh import eval_sh, num_sh_bases
from tinysplat_torch.utils.quaternions import quat_to_rotmat, random_quats

from tests._torch_threads import one_torch_thread  # noqa: F401

W, H = 96, 64


def test_orbit_cameras_matrices_equal():
    for jc, tc in zip(jax_orbit_cameras(5, width=W, height=H),
                      orbit_cameras(5, width=W, height=H)):
        np.testing.assert_array_equal(tc.view_matrix, jc.view_matrix)
        np.testing.assert_array_equal(tc.proj_matrix, jc.proj_matrix)
        jp, tp = jc.params(), tc.params(device="cpu")
        np.testing.assert_array_equal(tp.viewmat.numpy(), np.asarray(jp.viewmat))
        np.testing.assert_array_equal(tp.projmat.numpy(), np.asarray(jp.projmat))
        np.testing.assert_array_equal(tp.cam_pos.numpy(), np.asarray(jp.cam_pos))
        assert float(tp.fx) == float(jp.fx) and float(tp.fy) == float(jp.fy)


def _cloud(n, seed):
    means, log_scales, quats, _, _ = random_gaussian_cloud(
        n, seed=seed, scale_range=(0.005, 0.08))
    # Push some splats behind the camera / through the near plane.
    means = means * np.float32(4.0)
    return means, np.exp(log_scales).astype(np.float32), quats


@pytest.mark.parametrize("cam_index", [0, 2])
def test_project_gaussians_matches_jax(cam_index):
    means, scales, quats = _cloud(400, seed=cam_index + 5)
    cam = orbit_cameras(4, width=W, height=H)[cam_index]
    view, proj = cam.view_matrix, cam.proj_matrix
    args = dict(glob_scale=1.0, fx=np.float32(cam.f_x), fy=np.float32(cam.f_y),
                cx=W / 2.0, cy=H / 2.0, img_height=H, img_width=W)
    ref = jax_project(jnp.asarray(means), jnp.asarray(scales),
                      quats=jnp.asarray(quats), viewmat=jnp.asarray(view),
                      full_projmat=jnp.asarray(proj @ view), **args)
    got = project_gaussians(torch.from_numpy(means), torch.from_numpy(scales),
                            quats=torch.from_numpy(quats), viewmat=torch.from_numpy(view),
                            full_projmat=torch.from_numpy(proj @ view), **args)
    valid = np.asarray(ref.valid)
    assert 0 < valid.sum() < len(valid)  # the case exercises the near clip
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(ref.radii))
    np.testing.assert_array_equal(got.num_tiles_hit.numpy(), np.asarray(ref.num_tiles_hit))
    for name in ("xys", "depths", "conics"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("degree,active", [(0, 0), (1, 1), (2, 2), (3, 3), (3, 1), (2, 0)])
def test_eval_sh_matches_jax(degree, active):
    rng = np.random.default_rng(degree * 10 + active)
    n = 64
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    coeffs = rng.normal(size=(n, num_sh_bases(degree), 3)).astype(np.float32)
    ref = jax_eval_sh(jnp.int32(active), jnp.asarray(dirs), jnp.asarray(coeffs))
    got = eval_sh(active, torch.from_numpy(dirs), torch.from_numpy(coeffs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # A 0-d tensor degree (the GaussianState field) gives the same colours.
    got_t = eval_sh(torch.tensor(active, dtype=torch.int32), torch.from_numpy(dirs),
                    torch.from_numpy(coeffs))
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


def test_quaternions():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(quat_to_rotmat(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    gen = torch.Generator().manual_seed(3)
    r = random_quats(gen, 1000)
    assert r.shape == (1000, 4)
    np.testing.assert_allclose(torch.linalg.norm(r, dim=1).numpy(), 1.0, atol=1e-6)
    again = random_quats(torch.Generator().manual_seed(3), 1000)
    np.testing.assert_array_equal(r.numpy(), again.numpy())
