"""Tile heights other than 16 px through the port (CPU, the plain versions
of K1 and K2) against the JAX package's ``tiled`` backend at the same
``tile_size``.

``tile_size`` is the tile HEIGHT; with ``tile_x = 0`` the tile is square,
as the JAX ``tiled`` backend cuts it, so both packages bin the same
(splat, tile) pairs and ``intersections`` agree exactly. 44x60 images are
multiples of none of 8, 12 and 32: the bottom and right tiles are ragged,
and at 12 and 32 px the sub-tile blocks of K1 and K2 are too.

Tolerances (ROADMAP, the reference suite's): images and alpha to 2e-4,
gradients normalised by their max to 5e-4; a train step's loss to 1e-5
relative and its new parameters as tests/test_torch_port_train.py holds
them; the 2-rank mesh trainer against the one-device trainer as
tests/test_torch_port_parallel.py holds the mesh trainer. Work counters
are held against a brute-force count.

torch runs on one thread here (tests/_torch_threads.py): in a process that
has run JAX, torch's CPU ``exp`` on a worker thread came back up to 1.5e-4
off in a few first calls (ROADMAP Queue 3, "torch's CPU exp on a worker
thread"), more than the gradient bar allows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu import train as jt
from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.data.synthetic import orbit_cameras as jax_orbit_cameras
from tinysplat_tpu.ops.rasterize import rasterize_tiled
from tinysplat_tpu.train_loop import Trainer as JaxTrainer

import tinysplat_torch as tt
from tinysplat_torch import train as pt
from tinysplat_torch.config import Config
from tinysplat_torch.data.synthetic import orbit_cameras, random_gaussian_cloud, synthetic_pcd
from tinysplat_torch.models.gaussians import PARAM_FIELDS
from tinysplat_torch.ops import rasterize_cuda as rc
from tinysplat_torch.parallel import local
from tinysplat_torch.parallel.sharding import Mesh
from tinysplat_torch.parallel.train_step import SSIM_HALO, make_sharded_train_step
from tinysplat_torch.scene import Scene
from tinysplat_torch.train_loop import Trainer

from tests import _torch_ranks as ranks
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_rasterize_tiled import random_case, to_jnp
from tests.test_torch_port_backward import _brute_counts
from tests.test_torch_port_rasterize import _torch_args
from tests.test_torch_port_train import CFG, FIELDS, _close_to_max, _gt, _jax_state, _leaves
from tests.test_torch_port_train import H as STEP_H
from tests.test_torch_port_train import W as STEP_W
from tests.test_torch_port_trainer import PARITY

IMG_TOL, GRAD_TOL = 2e-4, 5e-4
STEP = 3


def _case():
    return random_case(n=200, H=44, W=60, seed=21)


def _target(case):
    return np.random.default_rng(3).uniform(0, 1, (case[7], case[8], 4)).astype(np.float32)


@functools.cache
def _jax_tiled(tile_size):
    """JAX ``rasterize_tiled`` at ``tile_size``: image, alpha, intersections
    and the gradients of mean((img - target)^2) w.r.t. (xys, conics,
    colours, opacities), as numpy."""
    case = _case()
    xys, depths, radii, conics, colors, opac, valid, H, W, bg = to_jnp(case)
    tgt = jnp.asarray(_target(case))

    def loss(xys, conics, colors, opac):
        img, alpha, diag = rasterize_tiled(xys, depths, radii, conics, colors, opac, valid, H,
                                           W, bg, tile_size=tile_size, return_diagnostics=True)
        return jnp.mean((img - tgt) ** 2), (img, alpha, diag)

    (_, (img, alpha, diag)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(xys, conics, colors, opac)
    return (np.asarray(img), np.asarray(alpha), {k: int(v) for k, v in diag.items()},
            [np.asarray(g) for g in grads])


@pytest.mark.parametrize("tile_size", [8, 12, 32])
def test_rasterize_matches_jax_tiled(tile_size):
    """Image, alpha, gradients and intersections of ``rasterize_cuda`` at
    square tile_size x tile_size tiles equal the JAX 'tiled' backend's."""
    case = _case()
    img_j, alpha_j, diag_j, grads_j = _jax_tiled(tile_size)
    xys, depths, radii, conics, colors, opac, valid, H, W, bg = _torch_args(case)
    leaves = [x.clone().requires_grad_() for x in (xys, conics, colors, opac)]
    img, alpha, diag = rc.rasterize_cuda(leaves[0], depths, radii, leaves[1], leaves[2],
                                         leaves[3], valid, H, W, bg, tile_size=tile_size,
                                         return_diagnostics=True)
    assert diag == diag_j and diag["dup_dropped"] == diag["tile_dropped"] == 0
    np.testing.assert_allclose(img.detach().numpy(), img_j, atol=IMG_TOL)
    np.testing.assert_allclose(alpha.detach().numpy(), alpha_j, atol=IMG_TOL)
    torch.mean((img - torch.from_numpy(_target(case))) ** 2).backward()
    for x, ref, name in zip(leaves, grads_j, ("xys", "conics", "colors", "opacities")):
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(x.grad.numpy(), ref, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("tile_h,tile_x", [(12, 12), (32, 32), (8, 64)])
def test_subtiles_and_counters_of_ragged_tiles(tile_h, tile_x):
    """Sub-tile blocks of tiles that are not 16 x 16 multiples: the live
    prefixes, the per-entry rows of the plain backward and the work counters
    against brute force; a sub-tile's prefix is the max over the tile's
    pixels in it only."""
    case = random_case(n=160, H=40, W=72, seed=11)
    ti = rc.tile_inputs(*_torch_args(case)[:9], tile_x=tile_x, tile_h=tile_h)
    args = (ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy)
    out = rc.composite_fwd(*args, tile_x, tile_h)
    assert out.shape == (ti.tiles_x * ti.tiles_y, rc.OUT_ROWS, tile_h * tile_x)
    rows, cols = -(-tile_h // 16), -(-tile_x // 16)
    live = rc.subtile_live(out, ti.counts, tile_x, tile_h)
    last = out[:, 6].reshape(-1, tile_h, tile_x)
    for s in range(rows * cols):
        r, c = divmod(s, cols)
        want = last[:, 16 * r:16 * r + 16, 16 * c:16 * c + 16].amax(dim=(1, 2))
        assert torch.equal(live[:, s], torch.minimum(want.int(), ti.counts)), s
    counts = rc.composite_counts(*args, out, tile_x, tile_h)
    ref = _brute_counts(ti, out, tile_x, tile_h)
    for name in ("k1", "k1_box", "k2_pixel", "k2_box", "k2_sub", "kept"):
        assert counts["pairs"][name] == ref[name], name
    assert counts["warps"] == {"walked": ref["walked"], "kept": ref["kept warps"]}
    assert ref["kept outside the box"] == 0 and 0 < ref["kept"] < ref["k2_box"]
    gout = torch.from_numpy(np.random.default_rng(4).normal(size=tuple(out.shape))
                            .astype(np.float32))
    grads = rc.composite_bwd(*args, out, gout, tile_x, tile_h)
    assert grads.shape == (ti.entry_rank.shape[0], rc.TABLE_COLS)
    assert bool(torch.isfinite(grads).all()) and float(grads.abs().max()) > 0


def test_tile_shape_checks():
    args = _torch_args(random_case(n=20, H=16, W=16, seed=1))
    assert rc.subtile_grid(8, 8) == (1, 1) and rc.subtile_grid(12, 12) == (1, 1)
    assert rc.subtile_grid(64, 32) == (2, 4) and rc.subtile_grid(64, 8) == (1, 4)
    for bad_x, h in ((8, 16), (12, 8), (24, 32), (0, 8)):
        with pytest.raises(ValueError, match="sub-tile width"):
            rc.subtile_grid(bad_x, h)
    with pytest.raises(ValueError, match="height"):
        rc.subtile_grid(16, 0)
    with pytest.raises(ValueError, match="tile_size"):
        rc.rasterize_cuda(*args, tile_size=0)
    with pytest.raises(ValueError, match="tile_x"):  # a given width stays a multiple of 16
        rc.rasterize_cuda(*args, tile_size=8, tile_x=8)


@functools.cache
def _jax_step(tile_size):
    """One JAX train step through the 'tiled' backend at ``tile_size`` from
    fresh Adam moments: the background drawn, the rendered frame, the loss,
    the intersections, the first moments (0.1 x the gradients) and the new
    parameters, as numpy."""
    leaves = _leaves()
    cfg = JaxConfig(rasterizer="tiled", tile_size=tile_size, **CFG)
    state = _jax_state(leaves)
    key = jax.random.PRNGKey(7)
    cam = jax_orbit_cameras(3, width=STEP_W, height=STEP_H)[1].params()
    out = jt.make_train_step(cfg, STEP_H, STEP_W)(
        state, jt.init_opt_state(cfg, state), cam, jnp.asarray(_gt()), None, jnp.int32(STEP),
        key)
    return {"leaves": leaves, "bg": np.array(jt._resolve_background(cfg, key)),
            "rendered": np.asarray(out.rendered), "loss": float(out.metrics["loss"]),
            "inter": int(out.metrics["n_intersections"]),
            "mu": {k: np.asarray(getattr(out.opt_state[0].mu, k)) for k in FIELDS},
            "params": {k: np.asarray(getattr(out.state.params, k)) for k in FIELDS}}


@pytest.mark.parametrize("tile_size", [8, 32])
def test_render_and_train_step_match_jax_tiled(tile_size):
    """``render`` and one ``make_train_step`` step at ``tile_size`` (square
    tiles) against the JAX step through 'tiled' at the same tile size. The
    gradients are compared through Adam's first moments, which one step
    from zero moments sets to 0.1 x the gradient."""
    ref = _jax_step(tile_size)
    cfg = Config(tile_size=tile_size, tile_x=0, **CFG)
    state = tt.from_jax_params(ref["leaves"], "cpu")
    cam = orbit_cameras(3, width=STEP_W, height=STEP_H)[1].params(device="cpu")
    bg = torch.from_numpy(ref["bg"])
    rgb, extras = tt.render(state.params, state.alive, cam, STEP_H, STEP_W, 2, bg,
                            tile_size=tile_size, tile_x=0)
    assert extras["binning"]["intersections"] == ref["inter"]
    np.testing.assert_allclose(rgb.numpy(), ref["rendered"], atol=IMG_TOL)
    opt = pt.init_opt_state(cfg, state)
    out = tt.make_train_step(cfg, STEP_H, STEP_W)(state, opt, cam, torch.from_numpy(_gt()),
                                                  None, STEP, background=bg)
    assert int(out.metrics["n_intersections"]) == ref["inter"]
    np.testing.assert_allclose(out.rendered.detach().numpy(), ref["rendered"], atol=IMG_TOL)
    np.testing.assert_allclose(float(out.metrics["loss"]), ref["loss"], rtol=1e-5)
    lrs = pt.lr_tree(cfg)
    for name, t in out.state.params.fields():
        mu_ref = ref["mu"][name]
        _close_to_max(opt.state[t]["exp_avg"].numpy(), mu_ref, GRAD_TOL, f"mu {name}")
        diff = np.abs(t.detach().numpy() - ref["params"][name])
        clear = np.abs(mu_ref) >= 1e-3 * np.abs(mu_ref).max()
        assert diff[clear].max() <= 1e-6 + 1e-3 * lrs[name], name
        assert diff.max() <= 1e-6 + 2 * lrs[name], name


def _schedule(cls, cfg):
    """A trainer of ``cls`` holding only ``cfg`` and its step: what the
    coarse-to-fine schedule (``_c2f_dims``) reads."""
    tr = cls.__new__(cls)
    tr.cfg, tr.step = cfg, 0
    return tr


def test_trainer_coarse_to_fine_sizes_match_jax():
    """At tile_size 32 the coarse-to-fine stages snap (h, w) to whole
    32-px tiles, step for step as the JAX trainer does."""
    kw = dict(coarse_to_fine=True, c2f_start_scale=0.125, max_iter=48, tile_size=32,
              tile_x=0)
    jcam = jax_orbit_cameras(1, width=300, height=211)[0]
    cam = orbit_cameras(1, width=300, height=211)[0]
    jtr, tr = _schedule(JaxTrainer, JaxConfig(**kw)), _schedule(Trainer, Config(**kw))
    got, want = [], []
    for step in range(0, 30, 3):
        jtr.step = tr.step = step
        want.append(jtr._c2f_dims(jcam))
        got.append(tr._c2f_dims(cam))
    assert got == want
    coarse = [d for d in got if d != (211, 300)]
    assert coarse[0] == (32, 32) and len(set(coarse)) == 3 and len(coarse) < len(got)
    assert all(h % 32 == 0 and w % 32 == 0 for h, w in coarse)


def _toy_scene(n_cams=2, size=64, n=60):
    """Orbit views of a random cloud rendered by the port's dense oracle,
    and a start state of other splats."""
    means, log_scales, quats, colors, opac = random_gaussian_cloud(n, seed=7)
    gt = tt.init_from_pcd(means, colors * 255, sh_degree=1, capacity=64, device="cpu")
    with torch.no_grad():
        gt.params.scales[:n] = torch.from_numpy(log_scales)
        gt.params.opacities[:n] = torch.from_numpy(opac)
    cams = orbit_cameras(n_cams, width=size, height=size)
    for cam in cams:
        with torch.no_grad():
            rgb, _ = tt.render(gt.params, gt.alive, cam.params(device="cpu"), size, size, 1,
                               torch.zeros(3), rasterizer="dense")
        cam._image = rgb.numpy()
    pcd = synthetic_pcd(40, seed=2)
    return Scene(cams), tt.init_from_pcd(pcd.xyz, pcd.colors, sh_degree=1, capacity=64,
                                         device="cpu")


def test_mesh_trainer_at_32px_tiles_matches_one_device():
    """MeshTrainer on 2 gloo ranks (mesh (1, 2): one 32-px tile row a band
    of a 64-px image) against the one-device Trainer, 3 steps, at the
    bars tests/test_torch_port_parallel.py holds the mesh trainer to."""
    kw = dict(PARITY, rasterizer="auto", tile_size=32, tile_x=0, warmup_densify=100,
              max_iter=3)
    scene, start = _toy_scene()
    leaves = {k: getattr(start.params, k).numpy() for k in PARAM_FIELDS}
    leaves.update(alive=start.alive.numpy(), active_sh_degree=int(start.active_sh_degree))
    out = local.run(ranks.mesh_trainer_run, 2, args=((1, 2), kw, leaves, scene, 3),
                    device="cpu", timeout=300)
    tr = Trainer(Config(**kw), scene, start)
    tr.run(3)
    assert out[0]["step"] == tr.step == 3
    mu = tr.opt_state.moments()[0]
    lrs = pt.lr_tree(tr.cfg)
    for name, t in tr.state.params.fields():
        want, got = t.detach().numpy(), np.concatenate([s["params"][name] for s in out])
        k = 5.0 if name == "quats" else 1.0  # near-isotropic splats: rounding-level quat grads
        diff = np.abs(got - want)
        g_ref = mu[name].numpy()
        clear = np.abs(g_ref) >= 1e-3 * np.abs(g_ref).max()
        assert diff[clear].max() <= k * 2e-4 * np.abs(want).max() + 1e-6, name
        assert diff.max() <= 1e-6 + 16 * lrs[name], name
    accum = tr.state.means_grad_accum.numpy()
    np.testing.assert_allclose(np.concatenate([s["accum"] for s in out]), accum,
                               atol=2e-4 * np.abs(accum).max(), rtol=0)


def test_interleaved_bands_below_the_ssim_halo_raise():
    """Interleaved bands of tile rows shorter than the SSIM halo would drop
    SSIM window rows (the JAX sharded step asserts the same); contiguous
    bands take any tile height."""
    mesh = Mesh(data=1, tile=2, rank=0, groups={"data": None, "tile": None, "world": None})
    with pytest.raises(ValueError, match="SSIM halo"):
        make_sharded_train_step(Config(tile_size=8), 64, 64, 2, mesh)
    assert SSIM_HALO == 10
    make_sharded_train_step(Config(tile_size=8, band_interleave=False), 64, 64, 2, mesh)
