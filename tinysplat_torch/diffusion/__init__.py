"""Diffusion-guided novel views: the denoiser, VAE, DDIM and the
feature-volume conditioning.

Torch port of ``tinysplat_tpu.diffusion``. The UNet, VAE, DDIM scheduler
and pipeline are the port's own ``torch.nn`` modules (NCHW); the
Stable-Diffusion topology (``sd_unet``, ``sd_vae``, ``sd_clip``) loads a
diffusers directory (``port``); ``convert`` carries the JAX package's
params across.
"""
from .model_diffusion import EmbeddingMLP, FeatureAggregator, FeatureVolumeEncoder
from .pipeline import TinysplatDiffusionPipeline
from .scheduler import DDIMScheduler
from .unet import UNet2D, UNet2DCondition
from .vae import AutoencoderKL

__all__ = [
    "UNet2D",
    "UNet2DCondition",
    "AutoencoderKL",
    "DDIMScheduler",
    "FeatureVolumeEncoder",
    "FeatureAggregator",
    "EmbeddingMLP",
    "TinysplatDiffusionPipeline",
]
