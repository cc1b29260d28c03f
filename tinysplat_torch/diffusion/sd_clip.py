"""CLIP text encoder, transformers-checkpoint compatible.

Torch port of ``tinysplat_tpu.diffusion.sd_clip``: submodules are named so
that ``state_dict()`` keys are those of transformers' ``CLIPTextModel``
(``text_model.encoder.layers.0.self_attn.q_proj.weight``, ...).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, mask):
        b, n, _ = x.shape
        hd = self.hidden // self.heads

        def split(a):
            return a.reshape(b, n, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) * (hd ** -0.5))
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        att = torch.softmax(q @ k.transpose(2, 3) + mask, dim=-1)
        return self.out_proj((att @ v).transpose(1, 2).reshape(b, n, self.hidden))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, hidden_act: str):
        super().__init__()
        # SD 1.x text encoders use quick_gelu; SD 2.x (OpenCLIP ViT-H)
        # configs say "gelu" (exact).
        if hidden_act not in ("quick_gelu", "gelu"):
            raise NotImplementedError(f"CLIP hidden_act={hidden_act!r}")
        self.act = hidden_act
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x):
        h = self.fc1(x)
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int, hidden_act: str):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.mlp = CLIPMLP(hidden, intermediate, hidden_act)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab: int, positions: int, hidden: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, hidden)
        self.position_embedding = nn.Embedding(positions, hidden)


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPLayer(cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"],
                      cfg.get("hidden_act", "quick_gelu"))
            for _ in range(cfg["num_hidden_layers"]))


class _TextTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.embeddings = _Embeddings(cfg["vocab_size"], cfg["max_position_embeddings"],
                                      cfg["hidden_size"])
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"], eps=1e-5)


class CLIPTextModel(nn.Module):
    """transformers-compatible CLIP text encoder: (last_hidden_state,
    pooled_output), pooled the final-LN hidden state at each sequence's
    EOS position."""

    sd_topology = True  # keyed as diffusers / transformers (convert.py)

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        self.text_model = _TextTransformer(self.config)

    def forward(self, input_ids: torch.Tensor):
        tm = self.text_model
        b, n = input_ids.shape
        pos = torch.arange(n, device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)[None]
        causal = torch.full((n, n), -torch.inf, device=x.device).triu(1)[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        # transformers pooling: the first EOS position; configs with
        # eos_token_id == 2 keep the legacy argmax-of-ids behaviour.
        eos = self.config.get("eos_token_id", 49407)
        if eos == 2:
            at = torch.argmax(input_ids, dim=-1)
        else:
            at = torch.argmax((input_ids == eos).to(torch.int32), dim=-1)
        return x, x[torch.arange(b, device=x.device), at]
