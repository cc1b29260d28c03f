"""The port's mesh extraction (``mesh.py``, ``poisson.py``, camera
projection, ``export_cli --filetype OBJ``) and the semantic sidecar
(``semantic.py``) against the JAX package's.

A few hundred splats, grids of at most 32^3, 64x64 views. The iso-surfacer
(marching tetrahedra) is a numpy copy, so the same field must give the same
mesh bit for bit; the fields themselves come from float32 device code in
each package.

Tolerances: projected points to 1e-5 x the scene scale, backprojected
ones to 1e-5 x the scale of a float64 backprojection (the port's
precision; the JAX package's float32 one is ~1e-2 off it);
the density grid to the density tolerance (rtol 2e-4, atol 1e-6, as
tests/test_density.py holds the density); the Poisson indicator grid to
1e-4 x max|chi| (a float32 FFT of a splatted field) and its iso level to
1e-4 x max|chi|; normals and outlier sets from the same inputs exactly (up
to the sign of an unoriented normal, to 1e-4).
"""
import os

import jax.numpy as jnp
import numpy as np
import torch

from tinysplat_tpu import mesh as jmesh
from tinysplat_tpu import poisson as jpoisson
from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.data.synthetic import random_gaussian_cloud
from tinysplat_tpu.models import gaussians as jg

import tinysplat_torch as tt
from tinysplat_torch import export_cli, mesh, poisson
from tinysplat_torch.data.synthetic import orbit_cameras
from tinysplat_torch.io.checkpoint import save_checkpoint
from tinysplat_torch.models.gaussians import PARAM_FIELDS

from tests._torch_threads import one_torch_thread  # noqa: F401

N, CAP = 160, 192


def _leaves(seed=3):
    means, log_scales, quats, colors, opac = random_gaussian_cloud(
        N, seed=seed, scale_range=(0.04, 0.15))

    def pad(a, fill):
        out = np.full((CAP,) + a.shape[1:], fill, np.float32)
        out[:N] = a
        return out

    quats_p = pad(quats, 0.0)
    quats_p[N:, 0] = 1.0
    return {"means": pad(means, 0.0), "colors_dc": pad(colors, 0.0),
            "colors_rest": np.zeros((CAP, 3, 3), np.float32), "scales": pad(log_scales, -10.0),
            "quats": quats_p, "opacities": pad(opac + 1.5, -20.0),
            "alive": np.arange(CAP) < N, "active_sh_degree": np.int32(1)}


def _jax_state(leaves):
    return jg.GaussianState(
        params=jg.GaussianParams(**{k: jnp.asarray(leaves[k]) for k in PARAM_FIELDS}),
        alive=jnp.asarray(leaves["alive"]), means_grad_accum=jnp.zeros((CAP,), jnp.float32),
        active_sh_degree=jnp.int32(1))


def test_project_and_backproject_points_match_jax():
    jcam = jax_orbit_cameras(3, width=64, height=48)[1]
    cam = orbit_cameras(3, width=64, height=48)[1]
    for c in (jcam, cam):
        c.cx_off, c.cy_off = 2.5, -1.5
    pts = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32)
    scale = 3.0  # the orbit radius
    for kw in (dict(), dict(return_depth=True), dict(screen_coordinates=False)):
        ref = np.asarray(jcam.project_points(jnp.asarray(pts), **kw))
        got = cam.project_points(torch.from_numpy(pts), **kw)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * scale * 64, rtol=1e-5)
    screen = np.array(jcam.project_points(jnp.asarray(pts), return_depth=True))
    screen[:, 2] = np.random.default_rng(1).uniform(1.0, 5.0, 200)  # camera-z depth
    got = cam.backproject_points(torch.from_numpy(screen)).numpy()
    assert got.dtype == np.float32
    # The port backprojects in float64: held to numpy's float64 to 1e-5 x
    # the scale. The JAX package's float32 (its NDC z within 1e-3 of 1,
    # cond(proj @ view) ~2e4) lands ~1e-2 off it; held to that.
    P, V = cam.proj_matrix.astype(np.float64), cam.view_matrix.astype(np.float64)
    s = screen.astype(np.float64)
    ndc = np.stack([(s[:, 0] + 0.5 - (32 + 2.5)) / 64 * 2, (s[:, 1] + 0.5 - (24 - 1.5)) / 48 * 2,
                    (P[2, 2] * s[:, 2] + P[2, 3]) / s[:, 2], np.ones(len(s))], axis=1)
    world = ndc @ np.linalg.inv(P @ V).T
    exact = world[:, :3] / world[:, 3:]
    np.testing.assert_allclose(got, exact, atol=1e-5 * scale)
    ref = np.asarray(jcam.backproject_points(jnp.asarray(screen)))
    np.testing.assert_allclose(ref, exact, atol=1e-2 * scale)
    # A round trip: project to (x, y) and the camera z, back to the point.
    view = cam.view_matrix.astype(np.float64)
    z = pts @ view[:3, :3].T[:, 2] + view[2, 3]
    xy = cam.project_points(torch.from_numpy(pts))[:, :2].numpy()
    back = cam.backproject_points(torch.from_numpy(
        np.concatenate([xy, z[:, None]], 1).astype(np.float32))).numpy()
    front = z > 0.5
    np.testing.assert_allclose(back[front], pts[front], atol=1e-4 * scale)


def test_density_grid_matches_jax():
    leaves = _leaves()
    ref, ref_origin, ref_spacing = jmesh._density_grid(_jax_state(leaves), 20)
    got, origin, spacing = mesh._density_grid(tt.from_jax_params(leaves, "cpu"), 20,
                                              chunk=1000)
    np.testing.assert_array_equal(origin, ref_origin)
    assert spacing == ref_spacing and got.shape == (20, 20, 20)
    assert ref.max() > 0.5
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6)


def test_marching_tetrahedra_and_normals_are_the_jax_copy():
    leaves = _leaves()
    field, origin, spacing = jmesh._density_grid(_jax_state(leaves), 16)
    for fn in ("marching_tetrahedra", "_marching_tetrahedra_reference"):
        ref_v, ref_f = getattr(jmesh, fn)(field, 0.5, origin, spacing)
        got_v, got_f = getattr(mesh, fn)(field, 0.5, origin, spacing)
        assert len(ref_f) > 100, fn
        np.testing.assert_array_equal(got_v, ref_v, err_msg=fn)
        np.testing.assert_array_equal(got_f, ref_f, err_msg=fn)
    np.testing.assert_array_equal(mesh.vertex_normals(got_v, got_f),
                                  jmesh.vertex_normals(ref_v, ref_f))
    for a, b in ((mesh._TRI_TABLE, jmesh._TRI_TABLE), (mesh._TETS, jmesh._TETS)):
        np.testing.assert_array_equal(a, b)


def test_extract_mesh_marching_cubes_and_empty_state():
    leaves = _leaves()
    timings = {}
    verts, faces, normals = mesh.extract_mesh(tt.from_jax_params(leaves, "cpu"),
                                              resolution=20, timings=timings)
    ref_v, ref_f, _ = jmesh.extract_mesh(_jax_state(leaves), resolution=20)
    assert set(timings) == {"grid_knn_density", "marching_tetrahedra"}
    # Different float32 fields: the same surface, nearly the same topology.
    assert abs(len(faces) - len(ref_f)) <= 0.02 * len(ref_f)
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-6)
    dead = dict(leaves, alive=np.zeros(CAP, bool))
    v, f, n = mesh.extract_mesh(tt.from_jax_params(dead, "cpu"))
    assert v.shape == (0, 3) and f.shape == (0, 3) and n.shape == (0, 3)


def _sphere(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    return (p * 0.7 + rng.normal(scale=0.003, size=(n, 3))).astype(np.float32)


def test_normals_and_outliers_match_jax():
    pts = _sphere()
    pts[:5] += 3.0  # far outliers
    np.testing.assert_array_equal(
        poisson.remove_statistical_outliers(pts, std_ratio=2.0, device="cpu"),
        jpoisson.remove_statistical_outliers(pts, std_ratio=2.0))
    origins = (pts * 3.0).astype(np.float32)  # cameras outside the sphere
    ref = np.asarray(jpoisson.estimate_normals(jnp.asarray(pts), jnp.asarray(origins)))
    got = poisson.estimate_normals(torch.from_numpy(pts), torch.from_numpy(origins)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    unoriented = poisson.estimate_normals(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(np.abs((unoriented * ref).sum(axis=1)), 1.0, atol=1e-4)


def test_solve_indicator_matches_jax():
    pts = _sphere()
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    ref_chi, ref_origin, ref_spacing, ref_iso = jpoisson.solve_indicator(
        jnp.asarray(pts), jnp.asarray(nrm), resolution=32)
    chi, origin, spacing, iso = poisson.solve_indicator(
        torch.from_numpy(pts), torch.from_numpy(nrm), resolution=32)
    ref_chi = np.asarray(ref_chi)
    scale = np.abs(ref_chi).max()
    np.testing.assert_allclose(chi.numpy(), ref_chi, atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(origin.numpy(), np.asarray(ref_origin), rtol=1e-6)
    np.testing.assert_allclose(spacing, float(ref_spacing), rtol=1e-6)
    assert abs(iso - ref_iso) <= 1e-4 * scale


def test_iso_surface_of_the_jax_indicator_is_the_jax_mesh(monkeypatch):
    """JAX's reconstruct, its indicator recorded on the way: the port's
    iso-surfacing of that indicator gives the same mesh."""
    pts = _sphere(2000, seed=1)
    origins = (pts * 3.0).astype(np.float32)
    seen = {}
    orig = jpoisson.solve_indicator

    def record(points, normals, **kw):
        seen["points"] = np.array(points)
        seen["out"] = orig(points, normals, **kw)
        return seen["out"]

    monkeypatch.setattr(jpoisson, "solve_indicator", record)
    ref_v, ref_f, ref_n = jpoisson.reconstruct(pts, origins, resolution=32)
    chi, origin, spacing, iso = seen["out"]
    v, f, n = poisson.iso_surface(np.asarray(chi), np.asarray(origin), float(spacing), iso,
                                  torch.from_numpy(seen["points"]))
    assert len(ref_f) > 500
    np.testing.assert_array_equal(f, ref_f)
    np.testing.assert_array_equal(v, ref_v)
    np.testing.assert_array_equal(n, ref_n)
    # The port's own pipeline: a closed sphere of the right radius.
    v2, f2, n2 = poisson.reconstruct(pts, origins, resolution=32, device="cpu")
    r = np.linalg.norm(v2, axis=1)
    assert len(f2) > 500 and abs(np.median(r) - 0.7) < 0.05
    assert poisson.reconstruct(pts[:10], device="cpu")[0].shape == (0, 3)


def _check_mesh(verts, faces, normals, lo, hi, label):
    """Non-empty, faces in range, unit normals wherever a vertex has one
    (chip_smoke.check_mesh: not where no face uses it or its faces have no
    area, as in the JAX package), vertices inside the live means' box
    padded by 10%."""
    from chip_smoke import check_mesh

    assert len(verts) > 100 and len(faces) > 100, label
    check_mesh(verts, faces, normals, lo, hi, label)


def test_export_cli_obj_both_ways_on_the_cpu(tmp_path):
    """The CLI from a checkpoint, both algorithms. The splats are shrunk to
    0.4x so the 16 orbit views (256x256) are a quarter covered: the level
    points, a KNN per view against every slot, stay a few seconds here."""
    leaves = _leaves()
    leaves["scales"] = leaves["scales"] + np.float32(np.log(0.4))
    state = tt.from_jax_params(leaves, "cpu")
    ckpt = str(tmp_path / "ck.npz")
    save_checkpoint(ckpt, state, step=1)
    means = leaves["means"][:N]
    lo, hi = means.min(axis=0), means.max(axis=0)
    for alg, flags in (("marching_cubes", ["--resolution", "24"]),
                       ("poisson", ["--poisson-depth", "5"])):
        out = tmp_path / f"{alg}.obj"
        summary = export_cli.main(["--filetype", "OBJ", "--device", "cpu",
                                   "--mesh-extraction-algorithm", alg, *flags, ckpt, str(out)])
        lines = out.read_text().splitlines()

        def rows(tag, cast):
            return np.asarray([[cast(x.split("/")[0]) for x in ln.split()[1:]]
                               for ln in lines if ln.startswith(tag + " ")])

        v, vn, f = rows("v", float), rows("vn", float), rows("f", int) - 1
        assert (summary["vertices"], summary["faces"]) == (len(v), len(f)), alg
        _check_mesh(v, f, vn, lo, hi, alg)
        assert summary["seconds"] and all(s >= 0 for s in summary["seconds"].values())
    assert "level_points" in summary["seconds"] and "fft_solve" in summary["seconds"]


def test_poisson_solve_has_no_host_fft(monkeypatch):
    """The spectral solve calls torch.fft on the grid's own device: no numpy
    FFT in the module, and a tensor on another device (here "meta", which
    has no data to copy to the host) comes back on that device."""
    with open(os.path.join(os.path.dirname(poisson.__file__), "poisson.py")) as fh:
        src = fh.read()
    assert "np.fft" not in src and "numpy.fft" not in src
    calls = []
    for name in ("fftn", "ifftn"):
        orig = getattr(torch.fft, name)
        monkeypatch.setattr(torch.fft, name,
                            lambda *a, _o=orig, _n=name, **kw: calls.append(_n) or _o(*a, **kw))
    chi = poisson._spectral_solve(torch.zeros((8, 8, 8, 3), device="meta"), 8, 4.0)
    assert chi.device.type == "meta" and chi.shape == (8, 8, 8)
    assert calls == ["fftn", "ifftn"]



def test_semantic_segmenter_caches_as_the_jax_copy(tmp_path):
    """The copied sidecar with an injected backend: the same maps, cached
    under the same file names as the JAX package's, read back without
    calling the backend."""
    from tinysplat_tpu.data.synthetic import orbit_cameras as jax_cams
    from tinysplat_tpu.scene import Scene as JaxScene
    from tinysplat_tpu.semantic import SemanticSegmenter as JaxSegmenter

    from tinysplat_torch.scene import Scene
    from tinysplat_torch.semantic import SemanticSegmenter

    def backend(camera):
        return np.full((camera.height, camera.width), int(camera.name[-3:]), np.int32)

    JaxSegmenter(JaxScene(jax_cams(3, width=16, height=8)), str(tmp_path / "jax"),
                 model=backend)
    cams = orbit_cameras(3, width=16, height=8)
    SemanticSegmenter(Scene(cams), str(tmp_path / "port"), model=backend)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for cam in cams:
        np.testing.assert_array_equal(
            cam.semantic_map, np.load(tmp_path / "jax" / f"{cam.name}.npy"))
        cam.semantic_map = None

    def refuse(camera):
        raise AssertionError("the cache was not read")

    SemanticSegmenter(Scene(cams), str(tmp_path / "port"), model=refuse)
    assert all(cam.semantic_map is not None for cam in cams)
