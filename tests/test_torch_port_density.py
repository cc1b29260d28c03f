"""The port's SuGaR density regularizer (``tinysplat_torch.regularizers``)
against the JAX package's (``tinysplat_tpu.regularizers.density``).

A few hundred splats (numpy-drawn, some dead, the cloud moved away from the
origin so the KNN's ||m||^2 - 2 p.m is not trivially exact), the same
points into both. The JAX package draws its sample indices and normals
from a key; the test recomputes those draws and hands them to the port.

Tolerances: KNN neighbour distances (recomputed in float64 from each
side's indices, sorted) to 1e-5 relative, and no dead splat ever chosen;
exact ties (copies of one splat) resolved to the same indices as JAX's;
the density with JAX's own ``knn_idx`` to rtol 2e-4, atol 1e-6 (the
tolerance of tests/test_density.py's numpy oracle); sampled points,
covariance inverses (to 1e-5 x each matrix's max), beta, the approximate density and the loss to 1e-5
relative; the loss's gradients to 5e-4 x each field's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.data.synthetic import random_gaussian_cloud
from tinysplat_tpu.models.gaussians import GaussianParams as JaxParams
from tinysplat_tpu.regularizers import density as jd

from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.models.gaussians import PARAM_FIELDS, GaussianParams
from tinysplat_torch.regularizers import density as pd

from tests._torch_threads import one_torch_thread  # noqa: F401

CAP, N, OFFSET = 256, 200, np.asarray([4.0, -3.0, 6.0], np.float32)
H, W = 48, 64


def _leaves(seed=0):
    means, log_scales, quats, colors, opac = random_gaussian_cloud(
        N, seed=seed, scale_range=(0.05, 0.2))
    rng = np.random.default_rng(seed)

    def pad(a, fill):
        out = np.full((CAP,) + a.shape[1:], fill, np.float32)
        out[:N] = a
        return out

    quats_p = pad(quats, 0.0)
    quats_p[N:, 0] = 1.0
    leaves = {"means": pad(means + OFFSET, 0.0), "colors_dc": pad(colors, 0.0),
              "colors_rest": np.zeros((CAP, 3, 3), np.float32),
              "scales": pad(log_scales, -10.0), "quats": quats_p,
              "opacities": pad(rng.uniform(-1.0, 3.0, (N, 1)).astype(np.float32), -20.0)}
    alive = np.arange(CAP) < N
    alive[rng.choice(N, 30, replace=False)] = False  # dead slots among the live
    return leaves, alive


def _jax(leaves):
    return JaxParams(**{k: jnp.asarray(leaves[k]) for k in PARAM_FIELDS})


def _port(leaves, grad=False):
    return GaussianParams(**{k: torch.tensor(leaves[k], requires_grad=grad)
                             for k in PARAM_FIELDS})


def _points(n, seed=1, scale=0.8):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * scale + OFFSET).astype(np.float32)


def _sorted_dists(points, means, idx):
    d = np.linalg.norm(points[:, None, :].astype(np.float64)
                       - means[idx].astype(np.float64), axis=-1)
    return np.sort(d, axis=1)


@pytest.mark.parametrize("n_live,k,chunk", [(None, 16, 64), (5, 16, None), (None, 4, 7)])
def test_knn_indices_matches_jax(n_live, k, chunk):
    leaves, alive = _leaves()
    if n_live is not None:  # fewer live splats than k: k is clamped
        alive = np.zeros(CAP, bool)
        alive[[3, 40, 77, 150, 199][:n_live]] = True
    pts = _points(300)
    ref = np.asarray(jd.knn_indices(jnp.asarray(pts), jnp.asarray(leaves["means"]),
                                    jnp.asarray(alive), k=k, chunk=chunk or 256))
    got = pd.knn_indices(torch.from_numpy(pts), torch.from_numpy(leaves["means"]),
                         torch.from_numpy(alive), k=k, chunk=chunk).numpy()
    assert got.shape == ref.shape == (300, min(k, int(alive.sum())))
    assert alive[got].all()
    np.testing.assert_allclose(_sorted_dists(pts, leaves["means"], got),
                               _sorted_dists(pts, leaves["means"], ref), rtol=1e-5)
    # Nearest first.
    d = np.linalg.norm(pts[:, None] - leaves["means"][got], axis=-1)
    assert (np.diff(d, axis=1) >= -1e-5).all()


def test_knn_indices_break_ties_by_the_lower_index_as_jax():
    """MCMC copies sit exactly on their target: groups of equal distances
    across the k-th place (and past the top-(k+1) candidates) resolve to
    the lower indices, as jax.lax.top_k's, index for index."""
    leaves, alive = _leaves()
    means = leaves["means"].copy()
    src = np.nonzero(alive)[0]
    means[src[100:140]] = means[src[:40:4]].repeat(4, axis=0)  # 4 copies each of 10
    pts = np.concatenate([means[src[:40:4]] + 0.01, _points(60, seed=9)]).astype(np.float32)
    for k in (3, 16):
        ref = np.asarray(jd.knn_indices(jnp.asarray(pts), jnp.asarray(means),
                                        jnp.asarray(alive), k=k, chunk=32))
        got = pd.knn_indices(torch.from_numpy(pts), torch.from_numpy(means),
                             torch.from_numpy(alive), k=k, chunk=32).numpy()
        np.testing.assert_array_equal(got, ref)


def test_knn_indices_refuses_no_live_splats_and_keeps_tf32_setting():
    leaves, _ = _leaves()
    with pytest.raises(ValueError, match="no live splats"):
        pd.knn_indices(torch.zeros(4, 3), torch.from_numpy(leaves["means"]),
                       torch.zeros(CAP, dtype=torch.bool))
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        pd.knn_indices(torch.zeros(4, 3), torch.from_numpy(leaves["means"]),
                       torch.ones(CAP, dtype=torch.bool))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_density_at_points_with_jax_knn_matches_jax():
    leaves, alive = _leaves()
    pts = _points(257, seed=2)
    jp = _jax(leaves)
    idx = jd.knn_indices(jnp.asarray(pts), jp.means, jnp.asarray(alive), k=16)
    ref = np.asarray(jd.density_at_points(jnp.asarray(pts), idx, jp))
    got = pd.density_at_points(torch.from_numpy(pts), torch.tensor(np.asarray(idx)).long(),
                               _port(leaves)).numpy()
    assert ref.max() > 0.05  # the points sit inside the cloud
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6)


def test_covariance_inverse_and_probe_beta_match_jax():
    leaves, alive = _leaves()
    jp, tp = _jax(leaves), _port(leaves)
    got, ref = pd.covariance_inverse(tp).numpy(), np.asarray(jd.covariance_inverse(jp))
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)  # each matrix's max
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-5, rtol=0)
    idx = np.random.default_rng(3).integers(0, N, size=(50, 16))
    np.testing.assert_allclose(pd.probe_beta(tp, torch.from_numpy(idx)).numpy(),
                               np.asarray(jd.probe_beta(jp, jnp.asarray(idx))), rtol=1e-5)


def _jax_draws(key, leaves, alive, num):
    """The categorical indices and normals ``jd.sample_points`` draws."""
    k1, k2 = jax.random.split(key)
    areas = np.where(alive, np.abs(np.prod(np.exp(leaves["scales"]), axis=-1)), 0.0)
    logits = jnp.log(jnp.maximum(jnp.asarray(areas, jnp.float32), 1e-30))
    idxs = jax.random.categorical(k1, logits, shape=(num,))
    eps = jax.random.normal(k2, (num, 3), dtype=jnp.float32)
    return np.asarray(idxs), np.asarray(eps)


def test_sample_points_and_probe_with_the_jax_draws():
    leaves, alive = _leaves()
    key = jax.random.PRNGKey(11)
    jp = _jax(leaves)
    ref_pts, ref_idx = jd.sample_points(jp, jnp.asarray(alive), key, 400)
    idxs, eps = _jax_draws(key, leaves, alive, 400)
    np.testing.assert_array_equal(idxs, np.asarray(ref_idx))
    pts, got_idx = pd.sample_points(_port(leaves), torch.from_numpy(alive), 400,
                                    idxs=torch.tensor(idxs), eps=torch.tensor(eps))
    np.testing.assert_array_equal(got_idx.numpy(), idxs)
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref_pts), rtol=1e-5, atol=1e-5)
    # The whole probe: the same points, neighbours at the same distances.
    jprobe = jd.make_density_probe(jp, jnp.asarray(alive), key, num_samples=400)
    timings = {}
    probe = pd.make_density_probe(_port(leaves), torch.from_numpy(alive), 400,
                                  idxs=torch.tensor(idxs), eps=torch.tensor(eps),
                                  timings=timings)
    assert set(timings) == {"sample_s", "knn_s", "tied_rows"}
    p = np.asarray(jprobe.points)
    np.testing.assert_allclose(_sorted_dists(p, leaves["means"], probe.knn_idx.numpy()),
                               _sorted_dists(p, leaves["means"], np.asarray(jprobe.knn_idx)),
                               rtol=1e-5)
    np.testing.assert_allclose(probe.beta.numpy(), np.asarray(jprobe.beta), rtol=1e-5)
    # The generator path: dead splats never drawn, the draw repeatable.
    draws = [pd.sample_points(_port(leaves), torch.from_numpy(alive), 2000,
                              generator=torch.Generator().manual_seed(4))[1] for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and alive[draws[0].numpy()].all()


def _depth_map(seed):
    """A smooth depth map in [2, 4], like a rendered one: the projected
    pixel coordinates carry a few float32 ulps (~3e-5 px at this size), and
    the bilinear sample turns that into slope x 3e-5 (a white-noise map,
    slope ~2 a pixel, would move the estimate by ~6e-5)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    a, b, c = rng.uniform(0.5, 1.0, 3)
    return (3.0 + 0.6 * a * np.sin(x / (7 * b)) * np.cos(y / (5 * c))).astype(np.float32)


def _camera_pair():
    """A view with a principal-point offset, as the JAX and port camera
    params (the orbit looks at the moved cloud)."""
    jcam = jax_orbit_cameras(3, width=W, height=H, target=tuple(OFFSET))[1]
    cam = orbit_cameras(3, width=W, height=H, target=tuple(OFFSET))[1]
    for c in (jcam, cam):
        c.cx_off, c.cy_off = 3.0, -2.0
    return jcam.params(), cam.params("cpu")


@pytest.mark.parametrize("use_sdf", [False, True])
def test_approximate_density_matches_jax(use_sdf):
    leaves, _ = _leaves()
    jcp, cp = _camera_pair()
    pts = _points(300, seed=5, scale=1.5)
    depth = _depth_map(6)
    beta = np.random.default_rng(7).uniform(0.05, 0.3, 300).astype(np.float32)
    ref, rmask = jd.approximate_density(jnp.asarray(pts), jnp.asarray(depth), jcp,
                                        jnp.asarray(beta), H, W, return_sdf=use_sdf)
    got, mask = pd.approximate_density(torch.from_numpy(pts), torch.from_numpy(depth), cp,
                                       torch.from_numpy(beta), H, W, return_sdf=use_sdf)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    assert 0 < mask.sum() < 300  # some points outside the frustum
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_sdf", [False, True])
def test_density_loss_and_gradients_match_jax(use_sdf):
    leaves, alive = _leaves()
    jcp, cp = _camera_pair()
    key = jax.random.PRNGKey(3)
    jp = _jax(leaves)
    jprobe = jd.make_density_probe(jp, jnp.asarray(alive), key, num_samples=300)
    depth = _depth_map(8)

    def jloss(params, depth_map):
        return jd.density_loss(jprobe, params, depth_map, jcp, H, W, use_sdf=use_sdf)

    ref, (gp, gd) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(depth))
    probe = pd.DensityProbe(*(torch.tensor(np.asarray(x)) for x in jprobe))
    probe = probe._replace(knn_idx=probe.knn_idx.long())
    tp = _port(leaves, grad=True)
    depth_t = torch.tensor(depth, requires_grad=True)
    loss = pd.density_loss(probe, tp, depth_t, cp, H, W, use_sdf=use_sdf)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    grads = {k: (getattr(tp, k).grad, getattr(gp, k)) for k in
             ("means", "scales", "quats", "opacities")}
    grads["depth"] = (depth_t.grad, gd)
    for name, (got, want) in grads.items():
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=5e-4, err_msg=name)
