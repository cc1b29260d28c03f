"""Zero123-style novel-view diffusion pipeline.

Torch port of ``tinysplat_tpu.diffusion.pipeline``: generate a novel view
from N input views, conditioned two ways:

1. feature latents from the PixelNeRF-style volume encoder + aggregator,
   concatenated channel-wise into the denoiser input;
2. CLIP text + image embedding tokens through cross-attention, with
   classifier-free guidance (CFG) by doubling the batch: the unconditional
   half gets zeroed feature latents and the raw text embeddings.

Latents start from the VAE-encoded init image plus scheduler noise at the
step the strength sets (img2img), the DDIM loop runs over the UNet, and
the VAE decodes the result. The components are the port's modules
(``unet.py`` / ``vae.py`` / ``scheduler.py``), or the SD topology loaded
from a diffusers directory (``from_pretrained``). The forward passes run in
full float32, TF32 off (``utils.device.full_f32``).

Draws: the VAE posterior's ``eps`` and the start ``noise`` come from a
``torch.Generator``, in that order, or are passed in.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from typing import Dict, Optional

import torch
from torch import nn

from ..cameras import CameraParams
from ..utils.device import full_f32, resolve_device
from .model_diffusion import EmbeddingMLP, FeatureAggregator, FeatureVolumeEncoder
from .scheduler import DDIMScheduler
from .unet import UNet2DCondition
from .vae import AutoencoderKL

log = logging.getLogger(__name__)

NATIVE_FORMAT = "tinysplat_native"


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights as flax initializes them, drawn from ``generator`` (a
    CPU generator) in ``module.modules()`` order: conv and dense kernels
    from a normal truncated at 2 standard deviations with variance 1 /
    fan_in (lecun_normal), biases 0, norm scales 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                fan_in = w[0].numel()
                # Inverse CDF of the standard normal on (Phi(-2), Phi(2)),
                # rescaled to unit variance (0.8796... is the truncated std).
                lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
                u = torch.rand(w.shape, generator=generator) * (1 - 2 * lo) + lo
                z = math.sqrt(2) * torch.erfinv(2 * u - 1)
                w.copy_(z * (math.sqrt(1.0 / fan_in) / 0.87962566103423978))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module


@dataclasses.dataclass
class TinysplatDiffusionPipeline:
    """The modules (weights inside) and the scheduler; ``__call__`` runs
    inference."""

    feature_encoder: Optional[FeatureVolumeEncoder]
    feature_aggregator: Optional[FeatureAggregator]
    embedding_mlp: EmbeddingMLP
    unet: nn.Module
    vae: nn.Module
    scheduler: DDIMScheduler

    def parts(self) -> Dict[str, nn.Module]:
        """The weighted modules under the JAX package's params keys (the SD
        VAE itself, not its adapter)."""
        out = {"fe": self.feature_encoder, "fa": self.feature_aggregator,
               "em": self.embedding_mlp, "unet": self.unet,
               "vae": getattr(self.vae, "model", self.vae)}
        return {k: v for k, v in out.items() if v is not None}

    def to(self, device) -> "TinysplatDiffusionPipeline":
        dev = resolve_device(device)
        for m in (self.feature_encoder, self.feature_aggregator, self.embedding_mlp,
                  self.unet, self.vae):
            if m is not None:
                m.to(dev).eval()
        return self

    @classmethod
    def tiny(cls, sample_size: int = 16, latent_channels: int = 4,
             generator: Optional[torch.Generator] = None, device="cuda"):
        """Small random-init pipeline (tests, the trainer's fallback).
        ``sample_size`` is the latent resolution; images are 8x larger (VAE
        stride). The weights are drawn on the CPU, so a seed gives the same
        weights on every device."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        fe = FeatureVolumeEncoder(sample_size=sample_size * 2, num_channels=8,
                                  latent_dim=sample_size, unet_block_out_channels=(8, 16))
        fa = FeatureAggregator(input_dim=8, hidden_dim=16, code_len=2)
        em = EmbeddingMLP(conditioned_images=2, embed_dim=32)
        unet = UNet2DCondition(sample_size=sample_size,
                               in_channels=latent_channels + 8 + 3,  # latents + feature volume
                               out_channels=latent_channels, block_out_channels=(16, 32),
                               cross_attention_dim=32)
        vae = AutoencoderKL(latent_channels=latent_channels, block_out_channels=(8, 16, 32))
        for m in (fe, fa, em, unet, vae):
            init_weights(m, generator)
        return cls(fe, fa, em, unet, vae, DDIMScheduler()).to(dev)

    def save_native(self, model_dir: str) -> None:
        """Write a tiny-topology pipeline as ``config.json`` +
        ``params.msgpack``: the JAX package's native format (flax
        ``to_bytes`` of its params), which either package loads."""
        from .convert import tiny_flax_variables
        from .flax_msgpack import to_bytes

        if getattr(self.unet, "sd_topology", False):
            raise ValueError("the native format holds the tiny topology only")
        os.makedirs(model_dir, exist_ok=True)
        cfg = {"format": NATIVE_FORMAT, "sample_size": self.unet.sample_size,
               "latent_channels": self.vae.latent_channels}
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(cfg, f)
        params = {k: tiny_flax_variables(m) for k, m in self.parts().items()}
        with open(os.path.join(model_dir, "params.msgpack"), "wb") as f:
            f.write(to_bytes(params))

    @classmethod
    def load_native(cls, model_dir: str, device="cuda"):
        """Load a ``save_native`` checkpoint (either package's)."""
        from .convert import load_jax_params
        from .flax_msgpack import from_bytes

        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = json.load(f)
        pipe = cls.tiny(sample_size=cfg["sample_size"], latent_channels=cfg["latent_channels"],
                        device="cpu")
        with open(os.path.join(model_dir, "params.msgpack"), "rb") as f:
            load_jax_params(pipe, from_bytes(f.read()))
        return pipe.to(device)

    @classmethod
    def from_pretrained(cls, model_dir: str, generator: Optional[torch.Generator] = None,
                        device="cuda"):
        """Load a local diffusers-format checkpoint directory:
        ``model_dir/unet`` and ``model_dir/vae`` hold config.json +
        diffusion_pytorch_model.{safetensors,bin} (``port.py``), and
        ``model_dir/scheduler/scheduler_config.json`` is read when present.
        The conditioning heads (feature encoder / aggregator,
        EmbeddingMLP) are not part of such checkpoints: they are built to
        the UNet's config with random weights from ``generator``. When the
        UNet's in_channels leave no room for the feature volume (a stock SD
        checkpoint), feature conditioning is disabled. A native checkpoint
        directory loads through ``load_native``."""
        from .port import load_config, load_unet, load_vae
        from .sd_adapters import SDVAEAdapter

        dev = resolve_device(device)
        native_cfg = os.path.join(model_dir, "config.json")
        if os.path.exists(native_cfg):
            with open(native_cfg) as f:
                if json.load(f).get("format") == NATIVE_FORMAT:
                    return cls.load_native(model_dir, device=dev)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        unet = load_unet(os.path.join(model_dir, "unet"), device=dev)
        vae = load_vae(os.path.join(model_dir, "vae"), device=dev)
        unet_cfg = load_config(os.path.join(model_dir, "unet"))
        vae_cfg = load_config(os.path.join(model_dir, "vae"))

        latent_channels = vae_cfg.get("latent_channels", 4)
        sample_size = unet_cfg.get("sample_size", 64)
        ctx_dim = unet_cfg.get("cross_attention_dim", 768)
        feat_ch = unet_cfg.get("in_channels", 4) - latent_channels - 3
        if feat_ch > 0:
            # Surplus UNet input channels are taken for a tinysplat feature
            # volume (+3 xyz). Stock multi-channel SD variants (inpainting
            # in_channels=9, depth=5) expect mask / depth latents there.
            log.warning(
                "UNet in_channels=%d leaves %d channels beyond latents+xyz; "
                "treating them as a tinysplat feature volume (random-init "
                "encoder). If this is a stock inpainting/depth SD variant, "
                "that assumption is wrong.", unet_cfg.get("in_channels", 4), feat_ch)
        em = init_weights(EmbeddingMLP(conditioned_images=2, embed_dim=ctx_dim), generator)
        fe = fa = None
        if feat_ch > 0:
            fe = init_weights(FeatureVolumeEncoder(
                sample_size=sample_size * 2, num_channels=feat_ch, latent_dim=sample_size,
                unet_block_out_channels=(8, 16)), generator)
            fa = init_weights(FeatureAggregator(input_dim=feat_ch, hidden_dim=16, code_len=2),
                              generator)
        sched_cfg = os.path.join(model_dir, "scheduler", "scheduler_config.json")
        sched = (DDIMScheduler.from_config_file(sched_cfg) if os.path.exists(sched_cfg)
                 else DDIMScheduler())
        return cls(fe, fa, em, unet, SDVAEAdapter(vae, vae_cfg.get("scaling_factor", 0.18215)),
                   sched).to(dev)

    @torch.no_grad()
    def __call__(
        self,
        init_images: torch.Tensor,  # (B, 3, H, W) in [-1, 1]
        target_cameras: CameraParams,  # batched (B,)
        input_cameras: CameraParams,  # batched (B, N)
        input_images: torch.Tensor,  # (B, N, 3, S, S) in [0, 1]
        image_embeds: Optional[torch.Tensor] = None,  # (B, N, E) CLIP embeds
        text_embeds: Optional[torch.Tensor] = None,  # (B, 2, E)
        num_inference_steps: int = 10,
        guidance_scale: float = 3.0,
        strength: float = 0.8,
        generator: Optional[torch.Generator] = None,
        eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Generated images (B, 3, H, W) in [-1, 1]."""
        with full_f32():
            return self._generate(init_images, target_cameras, input_cameras, input_images,
                                  image_embeds, text_embeds, num_inference_steps,
                                  guidance_scale, strength, generator, eps, noise)

    def _generate(self, init_images, target_cameras, input_cameras, input_images,
                  image_embeds, text_embeds, num_inference_steps, guidance_scale, strength,
                  generator, eps, noise):
        dev = init_images.device
        B = init_images.shape[0]
        E = self.embedding_mlp.embed_dim
        do_cfg = guidance_scale > 1.0

        # Conditioning tokens; under CFG the raw text embeddings are the
        # negative prompt.
        if image_embeds is None:
            image_embeds = torch.zeros((B, self.embedding_mlp.conditioned_images, E), device=dev)
        if text_embeds is None:
            text_embeds = torch.zeros((B, 2, E), device=dev)
        prompt = self.embedding_mlp(text_embeds, image_embeds)
        if do_cfg:
            prompt = torch.cat([text_embeds, prompt])

        feat_latents = None
        if self.feature_encoder is not None:
            feat_latents = prepare_feature_latents(self.feature_encoder,
                                                   self.feature_aggregator, target_cameras,
                                                   input_cameras, input_images, do_cfg)

        # img2img: run the LAST round(n * strength) steps (Python's round);
        # strength 0 returns the decoded init.
        latents0 = self.vae.encode(init_images, eps=eps, generator=generator)
        ts = self.scheduler.timesteps(num_inference_steps)
        init_timestep = min(round(num_inference_steps * strength), num_inference_steps)
        t_start = num_inference_steps - init_timestep
        if init_timestep == 0:
            return self.vae.decode(latents0)
        if noise is None:
            noise = torch.randn(latents0.shape, generator=generator, device=dev)
        latents = self.scheduler.add_noise(latents0, noise, ts[t_start])
        for i in range(t_start, num_inference_steps):
            t = int(ts[i])
            prev_t = int(ts[i + 1]) if i + 1 < num_inference_steps else -1
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            if feat_latents is not None:
                lat_in = torch.cat([lat_in, feat_latents], dim=1)
            out = self.unet(lat_in, torch.tensor([t], dtype=torch.float32, device=dev), prompt)
            if do_cfg:
                eps_u, eps_c = out.chunk(2)
                out = eps_u + guidance_scale * (eps_c - eps_u)
            latents = self.scheduler.step(out, t, latents, prev_t)
        return self.vae.decode(latents)


def prepare_feature_latents(feature_encoder: FeatureVolumeEncoder,
                            feature_aggregator: FeatureAggregator,
                            target_cameras: CameraParams, input_cameras: CameraParams,
                            input_images: torch.Tensor,
                            do_classifier_free_guidance: bool = False) -> torch.Tensor:
    """Encode + aggregate; under CFG a zeroed copy comes first."""
    feats, xyz = feature_encoder(target_cameras, input_images, input_cameras)
    out = feature_aggregator(feats, xyz)
    if do_classifier_free_guidance:
        out = torch.cat([torch.zeros_like(out), out])
    return out


def _dummy_cams(b: int, device="cpu") -> CameraParams:
    """``b`` identity cameras (batched), as the JAX package's."""
    eye = torch.eye(4, device=device).expand(b, 4, 4)
    proj = torch.diag(torch.tensor([1.0, 1.0, 1.0, 0.0], device=device))
    proj[2, 3], proj[3, 2] = -0.001, 1.0
    return CameraParams(viewmat=eye, projmat=proj.expand(b, 4, 4),
                        cam_pos=torch.zeros((b, 3), device=device),
                        fx=torch.full((b,), 100.0, device=device),
                        fy=torch.full((b,), 100.0, device=device),
                        cx_off=torch.zeros((b,), device=device),
                        cy_off=torch.zeros((b,), device=device))


def stack_cameras(cams, device) -> CameraParams:
    """Batched ``CameraParams`` of host ``Camera`` objects: a list gives
    the (B,) batch, a list of lists the (B, N) one."""
    ps = [stack_cameras(c, device) if isinstance(c, (list, tuple)) else c.params(device)
          for c in cams]
    return CameraParams(**{f.name: torch.stack([getattr(p, f.name) for p in ps])
                           for f in dataclasses.fields(CameraParams)})
