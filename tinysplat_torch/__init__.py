"""tinysplat_torch: the PyTorch + CUDA (NVIDIA Hopper) port of tinysplat_tpu.

A second package beside the JAX one, with its module paths and public
names. Plain tensor code is PyTorch; the JAX package's Pallas kernels become
kernels written by hand for Hopper under ``csrc/``, built by ``nvcc`` on
first use. Entry points take a ``device`` (default ``"cuda"``) and raise
when CUDA is asked for without a card; tests pass ``device="cpu"``, where
each kernel's plain PyTorch version runs instead.

Ported so far: serving rendered frames (checkpoint load -> projection ->
SH colours -> tile binning -> compositing, kernel K1) and one training step
(``make_train_step``: render -> L1 + DSSIM -> backward through the
compositing backward K2 and the gradient reduction, K3 under
``grad_reduce="mxu"`` -> Adam -> the densify gradient accumulator).
Densification, the trainer loop and checkpoint saving come next.
"""

from .cameras import Camera, CameraParams
from .config import Config
from .io.checkpoint import load_model
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

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "CameraParams",
    "Config",
    "GaussianParams",
    "GaussianState",
    "PointCloud",
    "Scene",
    "compute_losses",
    "from_jax_params",
    "from_state_dict",
    "init_from_pcd",
    "init_opt_state",
    "load_model",
    "make_train_step",
    "render",
    "state_dict",
]
