"""Minimal KL-autoencoder (latent-diffusion VAE counterpart), NCHW.

Torch port of ``tinysplat_tpu.diffusion.vae``: encode images to a
diagonal-Gaussian latent (sampled, scaled by ``scaling_factor``), decode
latents back to images in [-1, 1].
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .unet import _conv, _gn, auto_names


class _Down(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.conv_in = _conv(in_channels, channels[0])
        self.norms, self.convs = nn.ModuleList(), nn.ModuleList()
        cur = channels[0]
        for ch in channels:
            self.norms.append(_gn(cur))
            self.convs.append(_conv(cur, ch, stride=2))
            cur = ch

    def flax_children(self):
        kids = [("Conv", self.conv_in)]
        for n, c in zip(self.norms, self.convs):
            kids += [("GroupNorm", n), ("Conv", c)]
        return auto_names(kids)

    def forward(self, x):
        h = self.conv_in(x)
        for n, c in zip(self.norms, self.convs):
            h = c(F.silu(n(h)))
        return h


class _Up(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int], out_channels: int):
        super().__init__()
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        cur = in_channels
        for ch in channels:
            self.convs.append(_conv(cur, ch))
            self.norms.append(_gn(ch))
            cur = ch
        self.conv_out = _conv(cur, out_channels)

    def flax_children(self):
        kids = []
        for c, n in zip(self.convs, self.norms):
            kids += [("Conv", c), ("GroupNorm", n)]
        return auto_names(kids + [("Conv", self.conv_out)])

    def forward(self, x):
        h = x
        for c, n in zip(self.convs, self.norms):
            h = F.silu(n(c(F.interpolate(h, scale_factor=2, mode="nearest"))))
        return self.conv_out(h)


class AutoencoderKL(nn.Module):
    def __init__(self, in_channels: int = 3, latent_channels: int = 4,
                 block_out_channels: Sequence[int] = (32, 64, 128),  # 3 downsamples = /8
                 scaling_factor: float = 0.18215):
        super().__init__()
        chans = list(block_out_channels)
        self.in_channels, self.latent_channels = in_channels, latent_channels
        self.scaling_factor = scaling_factor
        self.encoder = _Down(in_channels, chans)
        self.quant = _conv(chans[-1], 2 * latent_channels, 1)
        self.post_quant = _conv(latent_channels, chans[-1], 1)
        self.decoder = _Up(chans[-1], list(reversed(chans)), in_channels)

    def flax_children(self):
        return [("encoder", self.encoder), ("quant", self.quant),
                ("post_quant", self.post_quant), ("decoder", self.decoder)]

    def encode(self, images: torch.Tensor, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images (B, 3, H, W) -> sampled scaled latents (B, C, H/8, W/8):
        mean + exp(logvar / 2) * eps, ``eps`` given or drawn from
        ``generator``."""
        mean, logvar = self.quant(self.encoder(images)).chunk(2, dim=1)
        logvar = torch.clamp(logvar, -30.0, 20.0)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        return (mean + torch.exp(0.5 * logvar) * eps) * self.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, C, h, w) -> images (B, 3, 8h, 8w) in [-1, 1]."""
        return torch.tanh(self.decoder(self.post_quant(latents / self.scaling_factor)))

    def forward(self, images, eps=None, generator=None):
        z = self.encode(images, eps, generator)
        return self.decode(z), z
