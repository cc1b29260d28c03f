"""Stable-Diffusion-topology ``UNet2DConditionModel``, NCHW.

Torch port of ``tinysplat_tpu.diffusion.sd_unet``, the diffusers
conditional UNet. Submodules are named so that ``state_dict()`` keys are
the diffusers keys (``down_blocks.0.attentions.1.transformer_blocks.0.
attn2.to_q.weight``, ...): a diffusers checkpoint loads with
``load_state_dict``.

Supported config surface (the SD 1.x / 2.x family): sample_size,
in_channels, out_channels, block_out_channels, down_block_types
(CrossAttnDownBlock2D | DownBlock2D), up_block_types (CrossAttnUpBlock2D |
UpBlock2D), layers_per_block, cross_attention_dim, attention_head_dim (the
number of heads, diffusers' historical naming; may be per block),
norm_num_groups, use_linear_projection (SD 2), flip_sin_to_cos, freq_shift,
transformer_layers_per_block.

Two choices follow the JAX package, where diffusers differs: the GEGLU
gate is the tanh-approximated GELU (flax's ``nn.gelu`` default; diffusers
uses the exact one), and the transformer's input GroupNorm uses epsilon
1e-5 (diffusers: 1e-6).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

SD_EPS = 1e-5


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10_000.0) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` semantics."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.to(torch.float32)[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """diffusers resnet; without ``temb_channels`` (the VAE's) no time
    projection."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 temb_channels: Optional[int] = None, eps: float = SD_EPS):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _attend(q, k, v, heads: int) -> torch.Tensor:
    """Multi-head softmax attention of (b, n, inner) queries on (b, m, inner)
    keys and values, as matmul + softmax (no fused kernel)."""
    b, n, inner = q.shape
    dh = inner // heads
    q = q.reshape(b, n, heads, dh).transpose(1, 2)
    k = k.reshape(b, -1, heads, dh).transpose(1, 2)
    v = v.reshape(b, -1, heads, dh).transpose(1, 2)
    att = torch.softmax((q @ k.transpose(2, 3)) / math.sqrt(dh), dim=-1)
    return (att @ v).transpose(1, 2).reshape(b, n, inner)


class CrossAttention(nn.Module):
    """diffusers ``Attention`` of the transformer blocks: bias-free q / k / v,
    ``to_out.0`` with a bias."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        ctx = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        return self.to_out[0](_attend(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x):
        a, b = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(b, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # diffusers: net = [GEGLU, Dropout, Linear] -> keys net.0 / net.2.
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=SD_EPS)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=SD_EPS)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=SD_EPS)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1, groups: int = 32, use_linear_projection: bool = False):
        super().__init__()
        self.linear = use_linear_projection
        self.norm = nn.GroupNorm(groups, channels, eps=SD_EPS)
        if use_linear_projection:
            self.proj_in = nn.Linear(channels, channels)
            self.proj_out = nn.Linear(channels, channels)
        else:
            self.proj_in = nn.Conv2d(channels, channels, 1)
            self.proj_out = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, dim_head, context_dim) for _ in range(depth))

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if not self.linear:
            x = self.proj_in(x)
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.linear:
            x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.linear:
            x = self.proj_out(x)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if not self.linear:
            x = self.proj_out(x)
        return x + residual


class Downsample2D(nn.Module):
    """Stride-2 conv downsample. The UNet pads symmetrically (padding 1:
    output pixel o reads inputs 2o-1..2o+1); the VAE pads asymmetrically,
    F.pad(0, 1, 0, 1) then no padding."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(channels, channels, 3, stride=2,
                              padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _heads_for(attention_head_dim, block_index: int, channels: int):
    """diffusers semantics: ``attention_head_dim`` is the NUMBER OF HEADS in
    UNet2DConditionModel (historical naming); may be per block."""
    if isinstance(attention_head_dim, (tuple, list)):
        n_heads = attention_head_dim[block_index]
    else:
        n_heads = attention_head_dim
    return n_heads, channels // n_heads


class _Block(nn.Module):
    """One down, mid or up block: ``resnets``, ``attentions`` (cross-attention
    blocks only) and ``downsamplers`` / ``upsamplers``."""

    def __init__(self, resnets, attentions=(), downsamplers=(), upsamplers=()):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        else:
            self.attentions = None
        if downsamplers:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers:
            self.upsamplers = nn.ModuleList(upsamplers)


class UNet2DConditionModel(nn.Module):
    """diffusers-compatible conditional UNet (see the module docstring)."""

    sd_topology = True  # keyed as diffusers / transformers (convert.py)

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        cfg = self.config = dict(config)
        chans = list(cfg["block_out_channels"])
        layers = cfg.get("layers_per_block", 2)
        groups = cfg.get("norm_num_groups", 32)
        ctx_dim = cfg.get("cross_attention_dim", 768)
        head_dim = cfg.get("attention_head_dim", 8)
        lin = cfg.get("use_linear_projection", False)
        depth = cfg.get("transformer_layers_per_block", 1)
        down_types, up_types = cfg["down_block_types"], cfg["up_block_types"]
        self.sample_size = cfg.get("sample_size", 64)
        self.in_channels = cfg.get("in_channels", 4)
        self.out_channels = cfg.get("out_channels", 4)
        self.cross_attention_dim = ctx_dim
        temb = chans[0] * 4

        def transformer(i, ch):
            n_heads, dh = _heads_for(head_dim, i, ch)
            return Transformer2DModel(ch, n_heads, dh, ctx_dim, depth, groups, lin)

        self.conv_in = nn.Conv2d(self.in_channels, chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chans[0], temb)
        self.down_blocks = nn.ModuleList()
        skips, cur = [chans[0]], chans[0]
        for i, btype in enumerate(down_types):
            ch, res, att = chans[i], [], []
            for _ in range(layers):
                res.append(ResnetBlock2D(cur, ch, groups, temb))
                if btype == "CrossAttnDownBlock2D":
                    att.append(transformer(i, ch))
                cur = ch
                skips.append(cur)
            down = []
            if i < len(down_types) - 1:
                down = [Downsample2D(ch)]
                skips.append(cur)
            self.down_blocks.append(_Block(res, att, downsamplers=down))
        mid = chans[-1]
        self.mid_block = _Block([ResnetBlock2D(cur, mid, groups, temb),
                                 ResnetBlock2D(mid, mid, groups, temb)],
                                [transformer(len(chans) - 1, mid)])
        cur = mid
        self.up_blocks = nn.ModuleList()
        for i, btype in enumerate(up_types):
            level = len(chans) - 1 - i
            ch, res, att = chans[level], [], []
            for _ in range(layers + 1):
                res.append(ResnetBlock2D(cur + skips.pop(), ch, groups, temb))
                if btype == "CrossAttnUpBlock2D":
                    att.append(transformer(level, ch))
                cur = ch
            up = [Upsample2D(ch)] if i < len(up_types) - 1 else []
            self.up_blocks.append(_Block(res, att, upsamplers=up))
        self.conv_norm_out = nn.GroupNorm(groups, cur, eps=SD_EPS)
        self.conv_out = nn.Conv2d(cur, self.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states):
        cfg = self.config
        t = torch.atleast_1d(torch.as_tensor(timesteps, device=sample.device))
        t_emb = timestep_embedding(t, self.conv_in.out_channels,
                                   flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
                                   freq_shift=cfg.get("freq_shift", 0.0))
        temb = self.time_embedding(t_emb)
        h = self.conv_in(sample)
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = res(h, temb)
                if block.attentions is not None:
                    h = block.attentions[j](h, encoder_hidden_states)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), encoder_hidden_states),
                           temb)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if block.attentions is not None:
                    h = block.attentions[j](h, encoder_hidden_states)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
