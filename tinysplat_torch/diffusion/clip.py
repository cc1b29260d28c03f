"""CLIP conditioning helpers for the diffusion pipeline (host side).

Torch port of ``tinysplat_tpu.diffusion.clip``: the empty-text CLIP
embedding and per-view CLIP image embeddings -> ``EmbeddingMLP`` -> 2
cross-attention tokens (under classifier-free guidance the text embedding
is the negative prompt). The CLIP models come from ``transformers``,
imported when an encoder is built; the pipeline accepts precomputed
embeddings instead.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils.device import full_f32, resolve_device
from .model_diffusion import clip_preprocess


class ClipEncoders:
    """Lazy holder for the tokenizer and the text / image CLIP models, which
    run on ``device``."""

    def __init__(self, model_id: str = "openai/clip-vit-large-patch14", device="cuda"):
        self.device = resolve_device(device)
        from transformers import CLIPTextModel, CLIPTokenizer, CLIPVisionModelWithProjection

        self.tokenizer = CLIPTokenizer.from_pretrained(model_id)
        self.text_encoder = CLIPTextModel.from_pretrained(model_id).to(self.device).eval()
        self.image_encoder = (CLIPVisionModelWithProjection.from_pretrained(model_id)
                              .to(self.device).eval())

    @torch.no_grad()
    def encode_text(self, prompts: List[str]) -> np.ndarray:
        """(B, seq, 768) text embeddings."""
        inputs = self.tokenizer(prompts, return_tensors="pt", padding=True)
        with full_f32():
            out = self.text_encoder(inputs.input_ids.to(self.device))[0]
        return out.cpu().numpy()

    @torch.no_grad()
    def encode_images(self, images: np.ndarray) -> np.ndarray:
        """images (B, 3, H, W) in [-1, 1] -> (B, 768) projected embeddings."""
        if images.min() < -1.0 or images.max() > 1.0:
            raise ValueError("Image should be in [-1, 1] range")
        pre = clip_preprocess(torch.as_tensor(images, dtype=torch.float32, device=self.device))
        with full_f32():
            out = self.image_encoder(pre).image_embeds
        return out.cpu().numpy()


@torch.no_grad()
def encode_cross_attention_inputs(clip: ClipEncoders, embedding_mlp, input_images: np.ndarray,
                                  do_classifier_free_guidance: bool = False) -> np.ndarray:
    """Empty-text + image-embedding tokens for ``input_images`` (B, N, 3, H,
    W) in [0, 1]."""
    b, n = input_images.shape[:2]
    text = clip.encode_text([""])  # (1, seq, 768)
    text = np.repeat(text[:, :2], b, axis=0)  # the first 2 tokens, per batch
    flat = input_images.reshape(b * n, *input_images.shape[2:]) * 2.0 - 1.0
    img = clip.encode_images(flat).reshape(b, n, -1)
    dev = next(embedding_mlp.parameters()).device
    with full_f32():
        prompt = embedding_mlp(torch.as_tensor(text, device=dev),
                               torch.as_tensor(img, device=dev)).cpu().numpy()
    if do_classifier_free_guidance:
        prompt = np.concatenate([text, prompt])
    return prompt
