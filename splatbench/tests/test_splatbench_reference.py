"""The plain reference against the port's CPU path (its kernels' plain
versions) at a tiny size: frames, the work counters, one training step."""
import pytest
import torch

from splatbench import inputs
from splatbench.reference import render as R
from splatbench.reference import train as RT
from tinysplat_torch.cameras import Camera
from tinysplat_torch.config import Config
from tinysplat_torch.models.gaussians import GaussianParams, GaussianState
from tinysplat_torch.ops import rasterize_cuda as rc
from tinysplat_torch.render import render, splat_inputs
from tinysplat_torch.train import init_opt_state, make_train_step

CFG = dict(n_splats=400, sh_degree=3, scale_range=[0.01, 0.08], opacity_logit_range=[-1, 3],
           sh_rest_std=0.05, height=70, width=128)
ORBIT = dict(views=4, orbit_radius=3.0, orbit_height=0.15, fov=0.9)
LRS = {"means": 0.00016, "colors_dc": 0.0025, "colors_rest": 0.000125, "scales": 0.005,
       "quats": 0.001, "opacities": 0.05}


def program_camera(c):
    return Camera(position=c.position, f_x=c.fx, f_y=c.fy, fov_x=c.fov_x, fov_y=c.fov_y,
                  view_matrix=c.view, width=c.width, height=c.height).params("cpu")


def program_params(cloud):
    return GaussianParams(**{k: v.clone() for k, v in cloud.items()})


@pytest.mark.parametrize("tile_x", [16, 64])
@pytest.mark.parametrize("view", [0, 1])
def test_frame_equals_the_port(tile_x, view):
    cloud = inputs.make_cloud(CFG, 12345678901, "cpu")
    oc = inputs.training_views(CFG, ORBIT)[view]
    bg = torch.tensor([0.2, 0.5, 0.7])
    rgb, ex = render(program_params(cloud), torch.ones(400, dtype=torch.bool),
                     program_camera(oc), 70, 128, 3, bg, tile_size=16, tile_x=tile_x,
                     dup_capacity=100_000, max_per_tile=4096)
    img, tiles = R.render(cloud, R.camera(oc, "cpu"), bg, 16, tile_x)
    assert tiles.ids.shape[0] == int(ex["binning"]["intersections"])
    assert float((rgb - img).abs().max()) <= 1e-6


def test_counts_equal_the_ports_counters():
    cloud = inputs.make_cloud(CFG, 7, "cpu")
    oc = inputs.training_views(CFG, ORBIT)[0]
    s = splat_inputs(program_params(cloud), torch.ones(400, dtype=torch.bool),
                     program_camera(oc), 70, 128, 3, torch.zeros(3), tile_size=16)
    ti = rc.tile_inputs(s.xys, s.proj.depths, s.proj.radii, s.proj.conics, s.colors4,
                        s.opacities, s.valid, 70, 128, dup_capacity=100_000,
                        max_per_tile=4096, tile_x=64, tile_h=16)
    out = rc.composite_fwd(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx, ti.sy,
                           64, 16)
    port = rc.composite_counts(ti.table, ti.entry_rank, ti.tile_starts, ti.counts, ti.sx,
                               ti.sy, out, 64, 16)["pairs"]
    sr = R.project(cloud, R.camera(oc, "cpu"))
    got = R.count_work(sr, R.bin_tiles(sr, 70, 128, 16, 64))
    assert (got["k1_box"], got["k2_box"], got["kept"]) == (
        port["k1_box"], port["k2_box"], port["kept"])


def test_train_step_equals_the_ports():
    cloud = inputs.make_cloud(CFG, 7, "cpu")
    oc = inputs.training_views(CFG, ORBIT)[0]
    gt = torch.rand(70, 128, 3, generator=torch.Generator().manual_seed(3))
    conf = Config(rasterizer="auto", tile_size=16, tile_x=64, dup_capacity=100_000,
                  max_per_tile=4096, background="black")
    state = GaussianState(params=program_params(cloud), alive=torch.ones(400, dtype=torch.bool),
                          means_grad_accum=torch.zeros(400),
                          active_sh_degree=torch.tensor(3, dtype=torch.int32))
    opt = init_opt_state(conf, state)
    out = make_train_step(conf, 70, 128)(state, opt, program_camera(oc), gt, None, 15001)
    ref = RT.train_steps(cloud, [R.camera(oc, "cpu")], [gt], [torch.zeros(3)], LRS, 0.2, 16, 64)
    assert float(out.metrics["loss"]) == pytest.approx(ref.losses[0], rel=1e-6)
    mu = opt.moments()[0]
    for k in inputs.LEAVES:
        g = mu[k] / 0.1
        assert float((g - ref.first_grad[k]).norm()) <= 1e-5 * float(ref.first_grad[k].norm())
        moved = getattr(state.params, k).detach() - cloud[k]
        assert float(moved.norm()) == pytest.approx(float((ref.params[k] - cloud[k]).norm()),
                                                    rel=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, float("inf")])
    got = R.round_tf32(x)
    assert got[0] == 1.0 and got[2] == 1.0 + 2 ** -10 and torch.isinf(got[3])
    assert got[1] in (1.0, 1.0 + 2 ** -10)
