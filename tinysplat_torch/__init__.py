"""tinysplat_torch: the PyTorch + CUDA (NVIDIA Hopper) port of tinysplat_tpu.

A second package beside the JAX one, with its module paths and public
names. Plain tensor code is PyTorch; the JAX package's Pallas kernels become
kernels written by hand for Hopper under ``csrc/``, built by ``nvcc`` on
first use. Entry points take a ``device`` (default ``"cuda"``) and raise
when CUDA is asked for without a card; tests pass ``device="cpu"``, where
each kernel's plain PyTorch version runs instead.

Ported so far: serving rendered frames (checkpoint load -> projection ->
SH colours -> tile binning -> compositing, kernel K1); one training step
(``make_train_step``: render -> L1 + DSSIM -> backward through the
compositing backward K2 and the gradient reduction, K3 under
``grad_reduce="mxu"`` -> Adam -> the densify gradient accumulator, with
the pose / appearance deltas of ``pose_opt`` / ``app_opt``); the trainer
(``train_loop.Trainer``: densify, capacity growth, compaction, checkpoints
and resume, ``python -m tinysplat_torch.train_cli``); the Hopper
counterparts of the JAX package's two kernel probes (``probes``); and the
data path: COLMAP and Blender datasets (``data``), SfM-depth
regularization (``depthest``), PLY / .splat export (``io.export``,
``python -m tinysplat_torch.export_cli``) and the live viewer beside a
running trainer (``viewer``, ``Trainer.run_async``); SuGaR density
regularization (``regularizers``), 3DGS-MCMC densification
(``models.densify_mcmc``) and mesh extraction to OBJ (``mesh``,
``poisson``, ``export_cli --filetype OBJ``), the semantic sidecar
(``semantic``), and multi-device training on ``torch.distributed``
(``parallel``: FSDP splat sharding over a ('data', 'tile') mesh of ranks,
interleaved pixel bands, ``MeshTrainer``, sharded checkpoints), and
diffusion-guided novel views (``diffusion``: the SD-1.x-topology UNet and
VAE from a diffusers directory, the tiny prior, DDIM and the feature-volume
conditioning; ``regularizers.diffusion_guidance`` and the trainer's
``regularize_diffusion``).
"""

from .cameras import Camera, CameraParams
from .config import Config
from .io.checkpoint import load_checkpoint, load_model, save_checkpoint
from .models.gaussians import (
    GaussianParams,
    GaussianState,
    from_jax_params,
    from_state_dict,
    init_from_pcd,
    state_dict,
)
from .render import render
from .scene import PointCloud, Scene
from .train import compute_losses, init_opt_state, make_train_step
from .train_loop import Trainer

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "CameraParams",
    "Config",
    "GaussianParams",
    "GaussianState",
    "PointCloud",
    "Scene",
    "Trainer",
    "compute_losses",
    "from_jax_params",
    "from_state_dict",
    "init_from_pcd",
    "init_opt_state",
    "load_checkpoint",
    "load_model",
    "make_train_step",
    "render",
    "save_checkpoint",
    "state_dict",
]
