"""Stable-Diffusion-topology ``AutoencoderKL``, NCHW (diffusers keys).

Torch port of ``tinysplat_tpu.diffusion.sd_vae``. Submodule names are the
diffusers keys, as in ``sd_unet.py``. The GroupNorms use epsilon 1e-6
(the JAX package leaves flax's default there; diffusers' VAE uses 1e-6
too).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .sd_unet import Downsample2D, ResnetBlock2D, Upsample2D, _Block

VAE_EPS = 1e-6
# Pre-0.16 diffusers checkpoints name the mid-block attention projections so.
LEGACY_ATTENTION_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v",
                          "proj_attn": "to_out.0"}


class VaeAttention(nn.Module):
    """Single-head self-attention over positions, with biases."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=VAE_EPS)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        y = self.to_out[0](att @ v)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _resnet(cin, cout, groups):
    return ResnetBlock2D(cin, cout, groups, eps=VAE_EPS)


def _mid(ch, groups):
    return _Block([_resnet(ch, ch, groups), _resnet(ch, ch, groups)],
                  [VaeAttention(ch, groups)])


def _run_mid(mid, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        chans = list(cfg["block_out_channels"])
        layers = cfg.get("layers_per_block", 2)
        groups = cfg.get("norm_num_groups", 32)
        self.conv_in = nn.Conv2d(cfg.get("in_channels", 3), chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cur = chans[0]
        for i, ch in enumerate(chans):
            res = []
            for _ in range(layers):
                res.append(_resnet(cur, ch, groups))
                cur = ch
            down = [Downsample2D(ch, asymmetric_pad=True)] if i < len(chans) - 1 else []
            self.down_blocks.append(_Block(res, downsamplers=down))
        self.mid_block = _mid(cur, groups)
        self.conv_norm_out = nn.GroupNorm(groups, cur, eps=VAE_EPS)
        self.conv_out = nn.Conv2d(cur, 2 * cfg.get("latent_channels", 4), 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        rev = list(reversed(cfg["block_out_channels"]))
        layers = cfg.get("layers_per_block", 2) + 1
        groups = cfg.get("norm_num_groups", 32)
        self.conv_in = nn.Conv2d(cfg.get("latent_channels", 4), rev[0], 3, padding=1)
        self.mid_block = _mid(rev[0], groups)
        self.up_blocks = nn.ModuleList()
        cur = rev[0]
        for i, ch in enumerate(rev):
            res = []
            for _ in range(layers):
                res.append(_resnet(cur, ch, groups))
                cur = ch
            up = [Upsample2D(ch)] if i < len(rev) - 1 else []
            self.up_blocks.append(_Block(res, upsamplers=up))
        self.conv_norm_out = nn.GroupNorm(groups, cur, eps=VAE_EPS)
        self.conv_out = nn.Conv2d(cur, cfg.get("out_channels", 3), 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class SDAutoencoderKL(nn.Module):
    """diffusers-compatible AutoencoderKL (encode / decode / forward)."""

    sd_topology = True  # keyed as diffusers / transformers (convert.py)

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        lc = self.config.get("latent_channels", 4)
        self.latent_channels = lc
        self.encoder = Encoder(self.config)
        self.decoder = Decoder(self.config)
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode(self, images, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, sample: bool = True):
        """The posterior sample ``mean + exp(logvar / 2) * eps`` (``eps``
        given or drawn from ``generator``), or (mean, logvar) when
        ``sample`` is False."""
        mean, logvar = self.quant_conv(self.encoder(images)).chunk(2, dim=1)
        logvar = torch.clamp(logvar, -30.0, 20.0)
        if not sample:
            return mean, logvar
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        return mean + torch.exp(0.5 * logvar) * eps

    def decode(self, latents):
        return self.decoder(self.post_quant_conv(latents))

    def forward(self, images, eps=None, generator=None):
        z = self.encode(images, eps, generator)
        return self.decode(z), z


def rename_legacy_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A VAE state dict with the pre-0.16 attention names (query, key,
    value, proj_attn) renamed to the current ones."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if len(parts) >= 2 and parts[-2] in LEGACY_ATTENTION_NAMES:
            k = ".".join(parts[:-2] + [LEGACY_ATTENTION_NAMES[parts[-2]], parts[-1]])
        out[k] = v
    return out
