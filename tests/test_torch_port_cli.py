"""The port's train CLI (``python -m tinysplat_torch.train_cli``) vs
``scripts/train.py``: flag parity with its ``arg_parser`` (loaded by path),
a synthetic run on the CPU whose checkpoint the JAX package loads, resume
from it, an MCMC + density-regularized run, and the flags once refused
(the diffusion views, the multi-device flags). Datasets,
depth and the viewer are tested in test_torch_port_{data,depthest,viewer}.py.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest

from tinysplat_tpu.config import Config as JaxConfig
from tinysplat_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint

from tinysplat_torch import train_cli
from tinysplat_torch.io import checkpoint as tck

from tests.test_torch_port_trainer import _two_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_parser():
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", os.path.join(REPO, "scripts", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.arg_parser()


def test_flag_parity_with_the_jax_cli():
    jax_actions = {a.dest: a for a in _jax_parser()._actions if a.dest != "help"}
    port_actions = {a.dest: a for a in train_cli.arg_parser()._actions if a.dest != "help"}
    # The port's own option is a flag of its own.
    assert set(port_actions) == set(jax_actions) | {"mcmc_refine_every"}
    assert port_actions["mcmc_refine_every"].default == 0
    for dest, ja in jax_actions.items():
        pa = port_actions[dest]
        assert pa.option_strings == ja.option_strings, dest
        assert type(pa) is type(ja) and pa.type == ja.type, dest
        if dest == "device":  # the port's entry points run on the card
            assert (pa.default, ja.default) == ("cuda", "tpu")
        else:
            assert pa.default == ja.default, dest
    args = train_cli.arg_parser().parse_args(
        ["--max-iter", "123", "--regularize-depth", "--lr-means", "0.001", "--no-viewer"])
    assert (args.max_iter, args.regularize_depth, args.lr_means, args.viewer) == (
        123, True, 0.001, False)


def test_synthetic_run_checkpoint_loads_in_jax_and_resumes(tmp_path):
    ck = tmp_path / "ck"
    common = ["--no-viewer", "--synthetic", "--device", "cpu", "--rasterizer", "dense",
              "--capacity", "512",
              "--save-checkpoints", "--checkpoint-dir", str(ck), "--checkpoint-interval", "10",
              "--pose-opt", "--app-opt", "--eval-holdout", "5"]
    tr = train_cli.main(["--train", "--max-iter", "20"] + common)
    assert tr.step == 20 and len(tr.scene.cameras) == 8 and len(tr.eval_cameras) == 2
    assert float(tr.pose_deltas.abs().sum()) > 0
    path = sorted(ck.glob("*-20.npz"))[0]
    state, opt, step, key = jax_load_checkpoint(str(path), JaxConfig())
    assert step == 20 and key is None
    for got, ref in zip(jax.tree.leaves(state), tck.state_leaves(tr.state)):
        np.testing.assert_array_equal(np.asarray(got), ref)
    for got, ref in zip(jax.tree.leaves(opt), tck.opt_leaves(tr.opt_state)):
        np.testing.assert_array_equal(np.asarray(got), ref)
    resumed = train_cli.main(["--train", "--max-iter", "22", "--load-checkpoint", str(path)]
                             + common)
    assert resumed.step == 22 and int(resumed._pose_cnt.sum()) == int(tr._pose_cnt.sum()) + 2
    assert np.isfinite(resumed.evaluate()["eval_psnr"])


@pytest.mark.parametrize("flags,slice_", [(["--regularize-diffusion"], "item 17"),
                                          (["--mesh-splat", "2"], "item 16"),
                                          (["--mesh-tile", "2"], "item 16"),
                                          (["--distributed"], "item 16")])
def test_unported_flags_raise(flags, slice_, tmp_path):
    """Every flag these cases once refused is ported now. --regularize-
    diffusion (item 17) with --diffusion-model-dir trains on the CPU: a
    native tiny pipeline (latent 4, 32 x 32 views) written here refreshes 2
    synthetic views at steps 1 and 2, and step 3 closes the window. The
    multi-device flags of item 16 each train 2 steps on 2 local gloo ranks
    (the mesh (2, 1), (1, 2) and, with --distributed alone, every rank on
    the tile axis) and write a sharded checkpoint."""
    common = ["--no-viewer", "--synthetic", "--device", "cpu"]
    if slice_ == "item 17":
        import torch

        from tinysplat_torch.diffusion.pipeline import TinysplatDiffusionPipeline

        model_dir = str(tmp_path / "prior")
        TinysplatDiffusionPipeline.tiny(sample_size=4, device="cpu").save_native(model_dir)
        tr = train_cli.main(flags + common + [
            "--rasterizer", "dense", "--train", "--max-iter", "3", "--diffusion-model-dir",
            model_dir, "--regularize-diffusion-start", "1", "--regularize-diffusion-end", "3",
            "--interval-diffusion", "1", "--lambda-diffusion", "0.2",
            "--diffusion-inference-steps", "2"])
        guidance = tr._diffusion_guidance
        assert tr.cfg.regularize_diffusion and tr.cfg.diffusion_model_dir == model_dir
        assert guidance.size == 32 and [c.name for c in guidance.cameras] == [
            "diffusion_0", "diffusion_1"]
        assert all(c.get_original_image().shape == (32, 32, 3) for c in guidance.cameras)
        assert tr.step == 3 and len(tr.scene.cameras) == 10  # the window closed at step 3
        assert bool(torch.isfinite(tr.last_metrics["loss"]))
        return
    from tinysplat_torch.parallel import local

    from tests import _torch_ranks

    argv = flags + common + ["--train", "--max-iter", "2", "--save-checkpoints",
                             "--checkpoint-interval", "2", "--checkpoint-dir", str(tmp_path)]
    ranks = local.run(_torch_ranks.cli_main, 2, args=(argv,), device="cpu", timeout=300)
    assert [(r["step"], r["type"]) for r in ranks] == [(2, "MeshTrainer")] * 2
    (ckpt,) = ranks[0]["files"]
    assert ckpt.endswith("-2.ckpt") and ranks[1]["files"] == [ckpt]
    assert sorted(os.listdir(tmp_path / ckpt)) == ["manifest.npz", "p0", "p1"]


def test_mcmc_density_run_through_the_cli(tmp_path):
    """--densify-strategy mcmc --regularize-density train on the CPU from a
    checkpoint whose opacities are trained-like (logits U(-1, 3): the
    density-start prune removes every splat below 0.5, which a fresh
    init's 0.1 would leave none of): the prune and a probe refresh at
    step 2, a refresh at 6 (step % 5 == 1), the refine pass at step 10 (the
    camera-count interval)."""
    import torch

    from tinysplat_torch.data.synthetic import synthetic_pcd
    from tinysplat_torch.models.gaussians import init_from_pcd

    pcd = synthetic_pcd(400, seed=1)
    state = init_from_pcd(pcd.xyz, pcd.colors, sh_degree=3, capacity=512, device="cpu")
    with torch.no_grad():
        state.params.opacities[:400] = torch.as_tensor(
            np.random.default_rng(0).uniform(-1.0, 3.0, (400, 1)), dtype=torch.float32)
    ck = str(tmp_path / "start.npz")
    tck.save_checkpoint(ck, state)
    tr = train_cli.main(["--train", "--no-viewer", "--synthetic", "--device", "cpu",
                         "--rasterizer", "dense", "--load-checkpoint", ck, "--max-iter", "10",
                         "--densify-strategy", "mcmc", "--regularize-density",
                         "--regularize-density-start", "2", "--regularize-density-end", "12",
                         "--density-samples", "2000", "--interval-densify", "5",
                         "--warmup-densify", "5", "--densify-end", "12"])
    assert tr.step == 10
    assert [p["step"] for p in tr.probe_history] == [2, 6]
    assert tr.probe_history[0]["live"] < 400  # the density-start prune
    assert [h["step"] for h in tr.densify_history] == [10]
    assert tr.densify_history[0]["grown"] > 0 and tr.state.capacity == 512
    assert np.isfinite(float(tr.last_metrics["loss_density"]))


@pytest.mark.parametrize("tile_size", [8, 12])
def test_synthetic_run_at_other_tile_heights(tile_size):
    """``--tile-size N --tile-x 0`` trains on square N x N tiles (the
    synthetic views are 128 px, a multiple of 8 but not of 12), through K1's
    and K2's plain versions on the CPU. (The default budgets may drop
    entries of deep tiles in the first epoch, as the JAX trainer's do,
    until the retune grows them.)"""
    tr = train_cli.main(["--train", "--no-viewer", "--synthetic", "--device", "cpu",
                         "--max-iter", "2", "--tile-size", str(tile_size), "--tile-x", "0"])
    assert tr.step == 2 and (tr.cfg.tile_size, tr.cfg.tile_x) == (tile_size, 0)
    m = tr.last_metrics
    assert np.isfinite(float(m["loss"])) and int(m["n_intersections"]) > 0
