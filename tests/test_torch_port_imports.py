"""The port stands alone: no JAX, and CUDA is never silently the CPU.

An AST scan, not a ``sys.modules`` check: the interpreter here imports jax
at start-up, so only the source can show what the port imports.
"""
import ast
import importlib
import os
import pkgutil

import numpy as np
import pytest
import torch

import tinysplat_torch as tt
from tinysplat_torch.data.synthetic import orbit_cameras, synthetic_pcd

from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tinysplat_tpu", "__graft_entry__")


def _port_sources():
    root = os.path.join(REPO, "tinysplat_torch")
    paths = [os.path.join(d, f) for d, _, files in os.walk(root)
             for f in files if f.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, "chip_smoke.py")]


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax():
    paths = _port_sources()
    assert len(paths) > 15 and all(os.path.exists(p) for p in paths)
    for path in paths:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"


SLICE_D_MODULES = ("data", "data.colmap", "data.dataset", "data.blender", "depthest",
                   "depthest.sparse", "depthest.align", "depthest.backends",
                   "depthest.estimator", "io.ply", "io.export", "export_cli", "viewer")


@pytest.mark.parametrize("module", SLICE_D_MODULES)
def test_slice_d_modules_import_no_jax(module):
    """The data, depth, export and viewer modules: copies of the JAX
    package's numpy-only modules, never imports of them."""
    rel = module.replace(".", os.sep)
    path = os.path.join(REPO, "tinysplat_torch", rel + ".py")
    if not os.path.exists(path):
        path = os.path.join(REPO, "tinysplat_torch", rel, "__init__.py")
    assert path in _port_sources()
    mods = list(_imported_modules(path))
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], mods
    importlib.import_module(f"tinysplat_torch.{module}")


SLICE_E_MODULES = ("regularizers", "regularizers.density", "models.densify_mcmc", "mesh",
                   "poisson", "semantic")


@pytest.mark.parametrize("module", SLICE_E_MODULES)
def test_slice_e_modules_import_no_jax(module):
    """The density regularizer, MCMC, mesh extraction, Poisson and the
    semantic sidecar: torch / numpy ports, never imports of the JAX
    package (semantic.py is a copy of a numpy-only module)."""
    test_slice_d_modules_import_no_jax(module)


SLICE_F_MODULES = ("parallel", "parallel.collectives", "parallel.sharding",
                   "parallel.train_step", "parallel.trainer", "parallel.local")


@pytest.mark.parametrize("module", SLICE_F_MODULES)
def test_slice_f_modules_import_no_jax(module):
    """The multi-device trainer: torch.distributed, never the JAX
    package's shard_map."""
    test_slice_d_modules_import_no_jax(module)


SLICE_G_MODULES = ("diffusion", "diffusion.clip", "diffusion.convert",
                   "diffusion.flax_msgpack", "diffusion.model_diffusion", "diffusion.pipeline",
                   "diffusion.port", "diffusion.scheduler", "diffusion.sd_adapters",
                   "diffusion.sd_clip", "diffusion.sd_unet", "diffusion.sd_vae",
                   "diffusion.unet", "diffusion.vae", "regularizers.diffusion_guidance",
                   "utils.rays", "utils.resize")


@pytest.mark.parametrize("module", SLICE_G_MODULES)
def test_slice_g_modules_import_no_jax(module):
    """The diffusion views: torch.nn modules, a first-party safetensors and
    msgpack reader, never flax or the JAX package."""
    test_slice_d_modules_import_no_jax(module)


def test_slice_g_modules_load_no_jax_at_run_time():
    """Importing the port and every slice-G and slice-H module in a fresh interpreter
    leaves jax, flax and the JAX package out of sys.modules."""
    import subprocess
    import sys

    code = ("import importlib, sys; [importlib.import_module('tinysplat_torch.' + m) for m in "
            f"{SLICE_G_MODULES + SLICE_H_MODULES!r}]; import tinysplat_torch.train_loop; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


SLICE_H_MODULES = ("scripts", "scripts.evaluate", "scripts.quality_bench",
                   "scripts.make_real_fixture", "scripts.quality_real",
                   "scripts.train_diffusion_prior", "scripts.diffusion_ab",
                   "scripts.train_1m_probe")
JAX_SCRIPTS = {f[:-3] for f in os.listdir(os.path.join(REPO, "scripts")) if f.endswith(".py")}


@pytest.mark.parametrize("module", SLICE_H_MODULES)
def test_slice_h_modules_import_no_jax(module):
    """The quality tools: package imports of the port, never the JAX
    package, ``__graft_entry__`` or a JAX script by file name (``from train
    import ...``, ``import make_real_fixture``)."""
    test_slice_d_modules_import_no_jax(module)
    rel = module.replace(".", os.sep)
    path = os.path.join(REPO, "tinysplat_torch", rel + ".py")
    if not os.path.exists(path):
        path = os.path.join(REPO, "tinysplat_torch", rel, "__init__.py")
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in JAX_SCRIPTS | {"scripts", "__graft_entry__"}, f"{path} imports {mod}"


TOOLS = ("evaluate", "quality_bench", "quality_real", "train_diffusion_prior",
         "diffusion_ab", "train_1m_probe")


@pytest.mark.parametrize("tool", TOOLS)
def test_quality_tools_default_to_the_card(tool, tmp_path):
    """Each tool's --device defaults to cuda and raises without a card,
    before it writes anything (make_real_fixture is numpy only: no device)."""
    mod = importlib.import_module(f"tinysplat_torch.scripts.{tool}")
    assert mod.arg_parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    argv = {"evaluate": [str(tmp_path / "missing.npz"), "--synthetic"],
            "quality_real": ["--scene-dir", str(tmp_path / "scene")],
            "train_diffusion_prior": ["--out-dir", str(tmp_path / "prior")],
            "diffusion_ab": ["--out", str(tmp_path / "ab.json")]}.get(tool, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv + ["--out", str(tmp_path / "o.json")] if tool in (
            "quality_bench", "train_1m_probe") else argv)
    assert os.listdir(tmp_path) == []


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cam = orbit_cameras(1, width=32, height=32)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        cam.params()  # default device="cuda"
    pcd = synthetic_pcd(50, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_from_pcd(pcd.xyz, pcd.colors)
    state = tt.init_from_pcd(pcd.xyz, pcd.colors, device="cpu")
    sd = tt.state_dict(state)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.from_state_dict(sd)
    path = str(tmp_path / "m.npz")
    np.savez(path, **{f"model/{k}": v for k, v in sd.items()})
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.load_model(path)
    leaves = {k: getattr(state.params, k).numpy() for k in
              ("means", "colors_dc", "colors_rest", "scales", "quats", "opacities")}
    leaves.update(alive=state.alive.numpy(), active_sh_degree=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.from_jax_params(leaves, "cuda")
    from tinysplat_torch import render_path

    with pytest.raises(RuntimeError, match="CUDA"):
        render_path.main([path, str(tmp_path / "out"), "--frames", "1"])
    assert not (tmp_path / "out").exists()
    from tinysplat_torch import export_cli
    from tinysplat_torch.io.export import export_ply, import_ply

    ply = str(tmp_path / "m.ply")
    export_ply(state, ply)
    with pytest.raises(RuntimeError, match="CUDA"):
        import_ply(ply)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_cli.main(["--filetype", "SPLAT", path, str(tmp_path / "m.splat")])
    assert not (tmp_path / "m.splat").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        export_cli.main(["--filetype", "OBJ", path, str(tmp_path / "m.obj")])
    assert not (tmp_path / "m.obj").exists()
    from tinysplat_torch import poisson

    with pytest.raises(RuntimeError, match="CUDA"):
        poisson.reconstruct(np.random.default_rng(0).normal(size=(40, 3)))


SLICE_N_MODULES = ("ops.binning", "ops.binning_cuda")


@pytest.mark.parametrize("module", SLICE_N_MODULES)
def test_slice_n_modules_import_no_jax(module):
    """Tile binning and its kernels' wrappers: torch and ctypes, never the
    JAX package's binning; the kernels' source is one of the built ones."""
    from tinysplat_torch.ops import _build

    test_slice_d_modules_import_no_jax(module)
    assert "binning" in _build.KERNELS and (_build.CSRC / "binning.cu").exists()


def test_every_module_imports_without_nvcc():
    """Importing builds nothing: kernels build at their first launch."""
    from tinysplat_torch.ops import _build

    names = [m.name for m in pkgutil.walk_packages(tt.__path__, "tinysplat_torch.")]
    for new in ("models.densify", "train_loop", "train_cli", "io.checkpoint",
                "probes.bitcast", "probes.op_costs") + SLICE_D_MODULES + SLICE_E_MODULES \
            + SLICE_F_MODULES + SLICE_G_MODULES + SLICE_H_MODULES + SLICE_N_MODULES:
        assert f"tinysplat_torch.{new}" in names
    for name in names:
        importlib.import_module(name)
    assert not _build._loaded
    for kernel in ("probe_bitcast", "probe_op_costs"):
        assert kernel in _build.KERNELS and (_build.CSRC / f"{kernel}.cu").exists()


def test_trainer_cli_and_probes_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tinysplat_torch import train_cli
    from tinysplat_torch.probes import bitcast, op_costs

    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--no-viewer", "--synthetic", "--train", "--max-iter", "1"])
    for probe in (bitcast, op_costs):
        with pytest.raises(RuntimeError, match="CUDA"):
            probe.main([])
    from tinysplat_torch.io.checkpoint import load_checkpoint, save_checkpoint

    pcd = synthetic_pcd(50, seed=0)
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, tt.init_from_pcd(pcd.xyz, pcd.colors, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(path, tt.Config())


def test_diffusion_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tinysplat_torch.diffusion.pipeline import TinysplatDiffusionPipeline

    with pytest.raises(RuntimeError, match="CUDA"):
        TinysplatDiffusionPipeline.tiny(sample_size=4)
    TinysplatDiffusionPipeline.tiny(sample_size=4, device="cpu").save_native(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        TinysplatDiffusionPipeline.from_pretrained(str(tmp_path))
    from tinysplat_torch.diffusion import port
    from tinysplat_torch.diffusion.clip import ClipEncoders

    for load in (port.load_unet, port.load_vae, port.load_text_encoder):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ClipEncoders()
