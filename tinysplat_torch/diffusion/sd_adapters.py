"""The SD-topology VAE behind the pipeline's interface.

Torch port of ``tinysplat_tpu.diffusion.sd_adapters``. The JAX adapters
move between NCHW and flax's NHWC and expose the config fields the
pipeline reads. The port's SD modules are NCHW already and carry those
fields, so the UNet needs no adapter (the pipeline calls
``sd_unet.UNet2DConditionModel`` itself); what is left is the VAE's
``scaling_factor`` and the ``encode`` / ``decode`` pair of ``vae.py``'s
interface.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class SDVAEAdapter(nn.Module):
    def __init__(self, model: nn.Module, scaling_factor: float = 0.18215):
        super().__init__()
        self.model = model
        self.scaling_factor = scaling_factor
        self.latent_channels = model.latent_channels

    def encode(self, images: torch.Tensor, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model.encode(images, eps, generator) * self.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.model.decode(latents / self.scaling_factor)
