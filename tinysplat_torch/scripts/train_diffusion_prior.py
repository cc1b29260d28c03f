"""Train the tiny novel-view diffusion prior on renders of the synthetic scene.

    python -m tinysplat_torch.scripts.train_diffusion_prior [--out-dir DIR]
    python -m tinysplat_torch.scripts.train_diffusion_prior --device cpu \
        --views 6 --sample-size 4 --batch 2 --vae-steps 3 --unet-steps 3 --out-dir DIR

Port of the JAX package's ``scripts/train_diffusion_prior.py``, with its
flags, defaults and JSON keys, on torch autograd. It trains the tiny
pipeline (``TinysplatDiffusionPipeline.tiny``) from scratch on posed
renders of the quality bench's GT scene (``make_gt_scene`` at 40 x 400),
so that ``diffusion_ab`` can A/B few-view training with a prior that has
seen the scene distribution:

  phase 1: the AutoencoderKL, sampled-latent reconstruction plus a
           latent-scale shrinkage standing in for the KL term,
           ``mse(out, x) + 1e-4 * mean((z / scaling_factor)^2)``, Adam at
           ``--lr``;
  phase 2: the conditional denoiser (feature encoder, aggregator,
           EmbeddingMLP, UNet) at ``--lr / 2`` with the epsilon-prediction
           DDPM objective on the frozen VAE's latents, conditioned on the
           target's two orbit neighbours through the feature volume;
           per-sample conditioning dropout (``--cfg-dropout``) keeps
           classifier-free guidance usable.

The GT views are rendered through the compositing kernel at generous
budgets (24n intersections, 16384 per tile); entries dropped are logged. The
training runs in full float32 (TF32 off), as the JAX package's matmul
precision "highest". Draws: the batch indices from numpy (equal to the JAX
script's), the VAE posterior eps, timesteps, noise and dropout mask from a
``torch.Generator`` seeded ``--seed + 1`` (``TorchDraws``; another source
can be passed to ``main``). Writes a native checkpoint (``save_native``,
loadable by either package) and ``training.json`` to ``--out-dir``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..cameras import CameraParams
from ..data.synthetic import orbit_cameras
from ..diffusion.pipeline import TinysplatDiffusionPipeline, stack_cameras
from ..utils.device import full_f32, resolve_device, synchronize
from ..utils.resize import resize
from .quality_bench import gt_renderer, make_gt_scene, make_gt_state


class TorchDraws:
    """The prior's random draws, from one ``torch.Generator`` on the device,
    in the order the steps take them."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def vae_eps(self, shape):
        """The VAE posterior's unit normal, (B, C, h, w)."""
        return torch.randn(shape, generator=self.gen, device=self.device)

    def denoiser(self, shape, num_timesteps: int, dropout: float):
        """(encode eps, timesteps (B,), noise, dropout mask (B, 1, 1, 1)) of
        one denoiser step on latents of ``shape``."""
        b = shape[0]
        eps = torch.randn(shape, generator=self.gen, device=self.device)
        t = torch.randint(0, num_timesteps, (b,), generator=self.gen, device=self.device)
        noise = torch.randn(shape, generator=self.gen, device=self.device)
        drop = torch.rand((b, 1, 1, 1), generator=self.gen, device=self.device) < dropout
        return eps, t, noise, drop


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the tiny novel-view diffusion prior")
    p.add_argument("--views", type=int, default=96)
    p.add_argument("--sample-size", type=int, default=16,
                   help="latent resolution; images are 8x larger")
    p.add_argument("--vae-steps", type=int, default=1500)
    p.add_argument("--unet-steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--cfg-dropout", type=float, default=0.1)
    p.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "diffusion_prior"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def render_dataset(views: int, size: int, seed: int, device):
    """(images (V, S, S, 3) in [0, 1], cameras, dropped entries per view):
    the GT scene at 40 x 400 from ``views`` orbit cameras, over black."""
    means, log_scales, quats, colors, opac = make_gt_scene(n_clusters=40, per_cluster=400,
                                                           seed=seed)
    n = len(means)
    gt_state = make_gt_state(means, log_scales, quats, colors, opac, 1, device)
    render_gt = gt_renderer(gt_state, 1, "auto", dup_capacity=24 * n, span_capacity=10 * n,
                            max_per_tile=16384)
    cams = orbit_cameras(views, width=size, height=size, radius=3.2, fov=0.9)
    imgs, drops = [], []
    for cam in cams:
        rgb, _, dropped = render_gt(cam.params(device), size, size)
        imgs.append(rgb)
        drops.append(dropped)
    if any(drops):
        logging.getLogger("prior").warning("GT views dropped %s intersections", drops)
    return torch.stack(imgs), cams, drops


def _take(cams: CameraParams, idx: torch.Tensor) -> CameraParams:
    return CameraParams(**{f.name: getattr(cams, f.name)[idx]
                           for f in dataclasses.fields(CameraParams)})


def main(argv: Optional[Sequence[str]] = None, draws=None,
         history: Optional[dict] = None) -> dict:
    """``draws``: the random source (default ``TorchDraws(seed + 1)``).
    ``history``, when given, receives the GT views' dropped entries
    (``gt_dropped``), the per-step losses of each phase (``vae_loss``,
    ``denoiser_loss``), each stage's seconds, the trained ``pipeline`` and
    each phase's Adam (``optimizers``)."""
    args = arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("prior")
    dev = resolve_device(args.device)
    history = {} if history is None else history

    S = args.sample_size * 8  # image side
    rng = np.random.default_rng(args.seed)

    # --- dataset: posed renders of the GT scene ---------------------------
    log.info("rendering %d posed views at %dx%d", args.views, S, S)
    t0 = time.perf_counter()
    imgs, cams, history["gt_dropped"] = render_dataset(args.views, S, args.seed, dev)
    synchronize(dev)
    history["render_s"] = time.perf_counter() - t0
    V = len(cams)

    pipe = TinysplatDiffusionPipeline.tiny(
        sample_size=args.sample_size, generator=torch.Generator().manual_seed(args.seed),
        device=dev)
    sched = pipe.scheduler
    draws = draws if draws is not None else TorchDraws(args.seed + 1, dev)
    imgs_nchw = imgs.permute(0, 3, 1, 2)
    imgs_dev = imgs_nchw * 2.0 - 1.0  # (V, 3, S, S) in [-1, 1]
    S_fe = pipe.feature_encoder.sample_size
    imgs_fe = resize(imgs_nchw, (S_fe, S_fe), "linear")  # [0, 1]
    cams_stack = stack_cameras(cams, dev)
    lat_shape = (args.batch, pipe.vae.latent_channels, args.sample_size, args.sample_size)

    with full_f32():
        # --- phase 1: VAE ----------------------------------------------------
        vae = pipe.vae
        opt = torch.optim.Adam(vae.parameters(), lr=args.lr, eps=1e-8)
        losses_vae = []
        t0 = time.perf_counter()
        for i in range(args.vae_steps):
            idx = torch.as_tensor(rng.integers(0, V, args.batch), device=dev)
            x = imgs_dev[idx]
            out, z = vae(x, eps=draws.vae_eps(lat_shape))
            lat = z / vae.scaling_factor
            loss = torch.mean((out - x) ** 2) + 1e-4 * torch.mean(lat ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses_vae.append(loss.detach())
            if (i + 1) % 250 == 0:
                log.info("vae step %d: loss %.5f", i + 1, float(loss))
        synchronize(dev)
        history["vae_s"] = time.perf_counter() - t0
        history["vae_loss"] = [float(x) for x in losses_vae]
        log.info("vae phase done in %.1f min", history["vae_s"] / 60)

        # --- phase 2: the conditional denoiser ---------------------------------
        fe, fa, em, unet = (pipe.feature_encoder, pipe.feature_aggregator,
                            pipe.embedding_mlp, pipe.unet)
        vae.requires_grad_(False)
        opt2 = torch.optim.Adam([p for m in (fe, fa, em, unet) for p in m.parameters()],
                                lr=args.lr * 0.5, eps=1e-8)
        E = em.embed_dim
        alphas = sched.alphas_cumprod.to(dev)
        zeros_e = torch.zeros((args.batch, 2, E), device=dev)
        t0 = time.perf_counter()
        losses, losses_dn = [], []
        for i in range(args.unet_steps):
            tgt = rng.integers(0, V, args.batch)
            # conditioning views: the two orbit neighbours of the target
            in_idx = np.stack([(tgt - 1) % V, (tgt + 1) % V], axis=1)
            tgt_t = torch.as_tensor(tgt, device=dev)
            in_t = torch.as_tensor(in_idx, device=dev)
            enc_eps, t, noise, drop = draws.denoiser(lat_shape, sched.num_train_timesteps,
                                                     args.cfg_dropout)
            x = imgs_dev[tgt_t]
            with torch.no_grad():
                lat0 = vae.encode(x, eps=enc_eps)
            a = alphas[t][:, None, None, None]
            lat_t = torch.sqrt(a) * lat0 + torch.sqrt(1.0 - a) * noise
            feats, xyz = fe(_take(cams_stack, tgt_t), imgs_fe[in_t], _take(cams_stack, in_t))
            feat_lat = torch.where(drop, 0.0, fa(feats, xyz))
            prompt = em(zeros_e, zeros_e)
            pred = unet(torch.cat([lat_t, feat_lat], dim=1), t.to(torch.float32), prompt)
            loss = torch.mean((pred - noise) ** 2)
            opt2.zero_grad(set_to_none=True)
            loss.backward()
            opt2.step()
            losses_dn.append(loss.detach())
            if (i + 1) % 500 == 0:
                lv = float(loss)
                losses.append(round(lv, 4))
                log.info("denoiser step %d: eps-mse %.4f", i + 1, lv)
        synchronize(dev)
        history["denoiser_s"] = time.perf_counter() - t0
        history["denoiser_loss"] = [float(x) for x in losses_dn]
        log.info("denoiser phase done in %.1f min", history["denoiser_s"] / 60)

    pipe.save_native(args.out_dir)
    meta = {"views": args.views, "image_size": S,
            "vae_steps": args.vae_steps, "unet_steps": args.unet_steps,
            "final_eps_mse": losses[-1] if losses else None,
            "loss_curve": losses}
    with open(os.path.join(args.out_dir, "training.json"), "w") as f:
        json.dump(meta, f, indent=1)
    out = {"metric": "diffusion_prior_eps_mse", "value": losses[-1] if losses else None,
           "out_dir": args.out_dir}
    print(json.dumps(out), flush=True)
    history.update(pipeline=pipe, optimizers={"vae": opt, "denoiser": opt2})
    return out


if __name__ == "__main__":
    main()
