"""The port's data layer (``tinysplat_torch.data``) and ``train_cli.build_scene``
vs the JAX package's (``tinysplat_tpu.data``, ``scripts/train.py``).

On the real-photo COLMAP fixture (tests/fixtures/real_colmap: 8 views
through an OPENCV camera with distortion, 360 SfM points), loaded as
tests/test_real_fixture.py loads it (``max_image_dimension=160``,
``lazy_images=False``): intrinsics, FOVs, view and projection matrices to
1e-6; images, point clouds, visible point ids and names identical. A COLMAP
binary round trip through the port's writers, and Blender
``transforms.json`` scenes written here (RGBA frames composited onto the
background) loaded by both packages. Both loaders run the same numpy / cv2
code, so everything but the float geometry is compared exactly.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.data import colmap as jax_colmap
from tinysplat_tpu.data.blender import BlenderDataset as JaxBlenderDataset
from tinysplat_tpu.data.dataset import Dataset as JaxDataset

from tinysplat_torch import train_cli
from tinysplat_torch.config import Config
from tinysplat_torch.data import BlenderDataset, Dataset, colmap, orbit_cameras

from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "real_colmap")
SPARSE = os.path.join(FIXTURE, "sparse", "0")
IMAGES = os.path.join(FIXTURE, "images")
GEOM_TOL = 1e-6
_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])


def jax_train_module():
    """``scripts/train.py`` loaded by path (its ``build_scene``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", os.path.join(REPO, "scripts", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_cameras_match(cams, jcams):
    assert len(cams) == len(jcams) > 0
    for cam, jcam in zip(cams, jcams):
        assert cam.name == jcam.name
        assert (cam.width, cam.height) == (jcam.width, jcam.height)
        for attr in ("f_x", "f_y", "fov_x", "fov_y", "cx_off", "cy_off", "z_near", "z_far"):
            assert getattr(cam, attr) == pytest.approx(getattr(jcam, attr), abs=GEOM_TOL), attr
        for attr in ("view_matrix", "proj_matrix", "position"):
            np.testing.assert_allclose(getattr(cam, attr), np.asarray(getattr(jcam, attr)),
                                       atol=GEOM_TOL, rtol=0, err_msg=attr)
        if jcam.visible_point_ids is None:
            assert cam.visible_point_ids is None
        else:
            np.testing.assert_array_equal(cam.visible_point_ids, jcam.visible_point_ids)
        np.testing.assert_array_equal(cam.get_original_image(),
                                      np.asarray(jcam.get_original_image()))


def assert_pcds_equal(pcd, jpcd):
    for attr in ("point_ids", "xyz", "colors", "errors"):
        a, b = getattr(pcd, attr), np.asarray(getattr(jpcd, attr))
        assert a.dtype == b.dtype, attr
        np.testing.assert_array_equal(a, b, err_msg=attr)


def test_real_colmap_fixture_matches_jax():
    kw = dict(max_image_dimension=160, lazy_images=False)
    ds, jds = Dataset(SPARSE, IMAGES, **kw), JaxDataset(SPARSE, IMAGES, **kw)
    assert len(ds.cameras) == 8 and ds.pcd.xyz.shape == (360, 3)
    assert all(max(c.width, c.height) <= 160 for c in ds.cameras)
    assert_cameras_match(ds.cameras, jds.cameras)
    assert_pcds_equal(ds.pcd, jds.pcd)
    assert ds.spatial_extent == pytest.approx(jds.spatial_extent, abs=GEOM_TOL)


def test_colmap_binary_round_trip_with_the_port_writers(tmp_path):
    rec = colmap.load_reconstruction(SPARSE)
    colmap.write_cameras_binary(rec.cameras, str(tmp_path / "cameras.bin"))
    colmap.write_images_binary(rec.images, str(tmp_path / "images.bin"))
    colmap.write_points3d_binary(rec.points, str(tmp_path / "points3D.bin"))
    for loader in (colmap.load_reconstruction, jax_colmap.load_reconstruction):
        back = loader(str(tmp_path))
        assert list(back.cameras) == list(rec.cameras)
        for cid, cam in rec.cameras.items():
            got = back.cameras[cid]
            assert (got.model, got.width, got.height) == (cam.model, cam.width, cam.height)
            np.testing.assert_array_equal(got.params, cam.params)
        assert list(back.images) == list(rec.images)
        for iid, im in rec.images.items():
            got = back.images[iid]
            assert (got.name, got.camera_id) == (im.name, im.camera_id)
            for attr in ("qvec", "tvec", "xys", "point3d_ids"):
                np.testing.assert_array_equal(getattr(got, attr), getattr(im, attr))
        for attr in ("ids", "xyz", "rgb", "error"):
            np.testing.assert_array_equal(getattr(back.points, attr), getattr(rec.points, attr))


def write_blender_scene(tmp_path, n=3, size=24, alpha=128):
    """A NeRF-synthetic scene: RGBA PNG frames with extensionless file
    paths, one global ``camera_angle_x``, OpenGL camera-to-world poses."""
    from PIL import Image

    cams = orbit_cameras(n, width=size, height=size)
    rng = np.random.default_rng(3)
    frames = []
    for i, cam in enumerate(cams):
        c2w = np.linalg.inv(np.asarray(cam.view_matrix, np.float64)) @ _GL_TO_CV
        rgba = rng.integers(0, 256, size=(size, size, 4), dtype=np.uint8)
        rgba[..., 3] = alpha
        Image.fromarray(rgba, "RGBA").save(tmp_path / f"r_{i}.png")
        frames.append({"file_path": f"./r_{i}", "transform_matrix": c2w.tolist()})
    path = tmp_path / "transforms.json"
    path.write_text(json.dumps({"camera_angle_x": cams[0].fov_x, "frames": frames}))
    return path


@pytest.mark.parametrize("background", [(1.0, 1.0, 1.0), (0.0, 0.0, 0.0)])
def test_blender_scene_matches_jax(tmp_path, background):
    path = str(write_blender_scene(tmp_path))
    kw = dict(background=background, num_init_points=300, seed=4)
    ds, jds = BlenderDataset(path, **kw), JaxBlenderDataset(path, **kw)
    assert_cameras_match(ds.cameras, jds.cameras)
    assert_pcds_equal(ds.pcd, jds.pcd)
    img = ds.cameras[0].get_original_image()
    a = 128 / 255.0
    assert np.all(img >= (1 - a) * np.asarray(background, np.float32) - 1e-6)


def _cfgs(**kw):
    return Config(**kw), JaxConfig(**kw)


def test_build_scene_on_the_colmap_fixture_matches_jax():
    kw = dict(dataset_dir=FIXTURE, colmap_path=SPARSE, images_path=IMAGES,
              max_image_dimension=160)
    cfg, jcfg = _cfgs(**kw)
    scene, pcd, cfg_out = train_cli.build_scene(cfg, "cpu")
    jscene, jpcd, jcfg_out = jax_train_module().build_scene(jcfg)
    assert cfg_out == cfg and jcfg_out.background == cfg_out.background == "random"
    assert_cameras_match(scene.cameras, jscene.cameras)
    assert_pcds_equal(pcd, jpcd)
    assert scene.seed == jscene.seed
    assert [scene.get_random_camera(s).name for s in range(12)] == [
        jscene.get_random_camera(s).name for s in range(12)]


@pytest.mark.parametrize("background,expect", [("random", "white"), ("black", "black")])
def test_build_scene_on_a_blender_scene_matches_jax(tmp_path, background, expect):
    write_blender_scene(tmp_path)
    kw = dict(dataset_dir=str(tmp_path), colmap_path=str(tmp_path / "sparse" / "0"),
              images_path=str(tmp_path / "images"), background=background,
              random_init_points=200)
    cfg, jcfg = _cfgs(**kw)
    scene, pcd, cfg_out = train_cli.build_scene(cfg, "cpu")
    jscene, jpcd, jcfg_out = jax_train_module().build_scene(jcfg)
    assert cfg_out.background == jcfg_out.background == expect
    assert cfg_out == dataclasses.replace(cfg, background=expect)
    assert_cameras_match(scene.cameras, jscene.cameras)
    assert_pcds_equal(pcd, jpcd)
