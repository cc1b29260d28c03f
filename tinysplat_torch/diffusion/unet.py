"""Minimal UNets (unconditional + cross-attention conditional), NCHW.

Torch port of ``tinysplat_tpu.diffusion.unet``: a sinusoidal timestep
embedding through an MLP; resnet blocks with GroupNorm + SiLU; self-attention
at the bottleneck; cross-attention on an ``encoder_hidden_states`` sequence
in every block of the conditional variant. Config field names follow the
diffusers conventions (sample_size, in_channels, out_channels,
block_out_channels, layers_per_block).

Every module lists its children in the order the flax modules create them
(``flax_children``), so that ``convert.py`` can name them as flax's
auto-naming does (``Conv_0``, ``ResnetBlock_1``, ``Dense_2``, ...).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# flax's nn.GroupNorm default epsilon (torch's default is 1e-5).
FLAX_GN_EPS = 1e-6


def auto_names(children: Sequence[Tuple[str, nn.Module]]) -> List[Tuple[str, nn.Module]]:
    """flax's auto-names for ``children`` given in creation order as
    (flax class name, module): each class counts from 0."""
    seen, out = {}, []
    for cls, mod in children:
        out.append((f"{cls}_{seen.get(cls, 0)}", mod))
        seen[cls] = seen.get(cls, 0) + 1
    return out


def _gn(channels: int) -> nn.GroupNorm:
    """GroupNorm with the largest power-of-two group count (<= 32) that
    divides ``channels``, at flax's epsilon."""
    g = 32
    while g > 1 and channels % g:
        g //= 2
    return nn.GroupNorm(g, channels, eps=FLAX_GN_EPS)


def _conv(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (DDPM convention). t: (B,) -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int):
        super().__init__()
        self.norm1 = _gn(in_channels)
        self.conv1 = _conv(in_channels, out_channels)
        self.temb = nn.Linear(temb_channels, out_channels)
        self.norm2 = _gn(out_channels)
        self.conv2 = _conv(out_channels, out_channels)
        self.shortcut = _conv(in_channels, out_channels, 1) if in_channels != out_channels else None

    def flax_children(self):
        kids = [("GroupNorm", self.norm1), ("Conv", self.conv1), ("Dense", self.temb),
                ("GroupNorm", self.norm2), ("Conv", self.conv2)]
        if self.shortcut is not None:
            kids.append(("Conv", self.shortcut))
        return auto_names(kids)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class Attention(nn.Module):
    """Self- or cross-attention over spatial positions; residual."""

    def __init__(self, channels: int, num_heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        kv = channels if context_dim is None else context_dim
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(kv, channels)
        self.v = nn.Linear(kv, channels)
        self.out = nn.Linear(channels, channels)

    def flax_children(self):
        return auto_names([("Dense", m) for m in (self.q, self.k, self.v, self.out)])

    def forward(self, x, context: Optional[torch.Tensor] = None):
        b, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        ctx = tokens if context is None else context
        hd = c // self.num_heads

        def split(a):
            return a.reshape(b, -1, self.num_heads, hd).transpose(1, 2)

        q, k, v = split(self.q(tokens)), split(self.k(ctx)), split(self.v(ctx))
        attn = torch.softmax(q @ k.transpose(2, 3) / math.sqrt(hd), dim=-1)
        out = self.out((attn @ v).transpose(1, 2).reshape(b, h * w, c))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _UNetCore(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, block_out_channels: Sequence[int],
                 layers_per_block: int, context_dim: Optional[int] = None,
                 attn_head_dim: int = 32):
        super().__init__()
        chans = list(block_out_channels)
        ch0, temb_ch = chans[0], chans[0] * 4
        self.ch0 = ch0
        cross = context_dim is not None

        def heads(ch):
            return max(ch // attn_head_dim, 1)

        self.temb1 = nn.Linear(ch0, temb_ch)
        self.temb2 = nn.Linear(temb_ch, temb_ch)
        self.conv_in = _conv(in_channels, ch0)
        # Each down / up entry: (resnet, cross-attention or None); a down
        # level ends in a stride-2 conv, an up level in a 2x upsample conv.
        self.down_res, self.down_attn, self.downsample = (nn.ModuleList() for _ in range(3))
        skips, cur = [ch0], ch0
        for i, ch in enumerate(chans):
            for _ in range(layers_per_block):
                self.down_res.append(ResnetBlock(cur, ch, temb_ch))
                self.down_attn.append(Attention(ch, heads(ch), context_dim) if cross
                                      else nn.Identity())
                cur = ch
                skips.append(cur)
            if i < len(chans) - 1:
                self.downsample.append(_conv(cur, cur, stride=2))
                skips.append(cur)
        mid = chans[-1]
        self.mid_res1 = ResnetBlock(cur, mid, temb_ch)
        self.mid_self = Attention(mid, heads(mid))
        self.mid_cross = Attention(mid, heads(mid), context_dim) if cross else None
        self.mid_res2 = ResnetBlock(mid, mid, temb_ch)
        cur = mid
        self.up_res, self.up_attn, self.upsample = (nn.ModuleList() for _ in range(3))
        for i, ch in enumerate(reversed(chans)):
            for _ in range(layers_per_block + 1):
                self.up_res.append(ResnetBlock(cur + skips.pop(), ch, temb_ch))
                self.up_attn.append(Attention(ch, heads(ch), context_dim) if cross
                                    else nn.Identity())
                cur = ch
            if i < len(chans) - 1:
                self.upsample.append(_conv(cur, cur))
        self.norm_out = _gn(cur)
        self.conv_out = _conv(cur, out_channels)
        self.layers_per_block = layers_per_block
        self.levels = len(chans)
        self.cross = cross

    def _order(self):
        """(class, module) in the flax call order."""
        L, kids = self.layers_per_block, []
        kids += [("Dense", self.temb1), ("Dense", self.temb2), ("Conv", self.conv_in)]
        r = 0
        for i in range(self.levels):
            for _ in range(L):
                kids.append(("ResnetBlock", self.down_res[r]))
                if self.cross:
                    kids.append(("Attention", self.down_attn[r]))
                r += 1
            if i < self.levels - 1:
                kids.append(("Conv", self.downsample[i]))
        kids += [("ResnetBlock", self.mid_res1), ("Attention", self.mid_self)]
        if self.cross:
            kids.append(("Attention", self.mid_cross))
        kids.append(("ResnetBlock", self.mid_res2))
        r = 0
        for i in range(self.levels):
            for _ in range(L + 1):
                kids.append(("ResnetBlock", self.up_res[r]))
                if self.cross:
                    kids.append(("Attention", self.up_attn[r]))
                r += 1
            if i < self.levels - 1:
                kids.append(("Conv", self.upsample[i]))
        kids += [("GroupNorm", self.norm_out), ("Conv", self.conv_out)]
        return kids

    def flax_children(self):
        return auto_names(self._order())

    def forward(self, x, t, context: Optional[torch.Tensor] = None):
        t = torch.atleast_1d(torch.as_tensor(t, device=x.device))
        temb = self.temb2(F.silu(self.temb1(timestep_embedding(t, self.ch0))))
        if temb.shape[0] == 1 and x.shape[0] > 1:
            temb = temb.expand(x.shape[0], -1)
        ctx = context if self.cross else None
        h = self.conv_in(x)
        skips, r = [h], 0
        for i in range(self.levels):
            for _ in range(self.layers_per_block):
                h = self.down_res[r](h, temb)
                if ctx is not None:
                    h = self.down_attn[r](h, ctx)
                skips.append(h)
                r += 1
            if i < self.levels - 1:
                h = self.downsample[i](h)
                skips.append(h)
        h = self.mid_res1(h, temb)
        h = self.mid_self(h)
        if ctx is not None:
            h = self.mid_cross(h, ctx)
        h = self.mid_res2(h, temb)
        r = 0
        for i in range(self.levels):
            for _ in range(self.layers_per_block + 1):
                h = self.up_res[r](torch.cat([h, skips.pop()], dim=1), temb)
                if ctx is not None:
                    h = self.up_attn[r](h, ctx)
                r += 1
            if i < self.levels - 1:
                h = self.upsample[i](F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(h)))


class UNet2D(nn.Module):
    """Unconditional UNet; diffusers ``UNet2DModel`` counterpart. NCHW."""

    def __init__(self, sample_size: int = 64, in_channels: int = 3, out_channels: int = 64,
                 block_out_channels: Sequence[int] = (32, 64), layers_per_block: int = 1):
        super().__init__()
        self.sample_size, self.in_channels, self.out_channels = (sample_size, in_channels,
                                                                 out_channels)
        self.core = _UNetCore(in_channels, out_channels, block_out_channels, layers_per_block)

    def flax_children(self):
        return [("_UNetCore_0", self.core)]

    def forward(self, sample, timestep):
        return self.core(sample, timestep)


class UNet2DCondition(nn.Module):
    """Cross-attention-conditioned UNet; diffusers ``UNet2DConditionModel``
    counterpart (the denoiser of the pipeline). NCHW."""

    def __init__(self, sample_size: int = 32, in_channels: int = 8, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (64, 128), layers_per_block: int = 1,
                 cross_attention_dim: int = 768):
        super().__init__()
        self.sample_size, self.in_channels, self.out_channels = (sample_size, in_channels,
                                                                 out_channels)
        self.cross_attention_dim = cross_attention_dim
        self.core = _UNetCore(in_channels, out_channels, block_out_channels, layers_per_block,
                              context_dim=cross_attention_dim)

    def flax_children(self):
        return [("_UNetCore_0", self.core)]

    def forward(self, sample, timestep, encoder_hidden_states):
        return self.core(sample, timestep, encoder_hidden_states)
