"""DDIM noise scheduler.

Torch port of ``tinysplat_tpu.diffusion.scheduler``: deterministic DDIM
(Song et al. 2020) with a scaled-linear (Stable Diffusion) or linear beta
schedule, for epsilon or v predictions. ``alphas_cumprod`` is built in
float64 numpy and cast to float32 once, as the JAX package builds it.
"""
from __future__ import annotations

import json
import logging

import numpy as np
import torch

log = logging.getLogger(__name__)


class DDIMScheduler:
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "epsilon",
    ):
        self.num_train_timesteps = num_train_timesteps
        if prediction_type not in ("epsilon", "v_prediction"):
            raise NotImplementedError(
                f"prediction_type={prediction_type!r} (epsilon / v_prediction only)")
        self.prediction_type = prediction_type
        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps)
        else:
            raise ValueError(beta_schedule)
        self.alphas_cumprod = torch.as_tensor(np.cumprod(1.0 - betas).astype(np.float32))
        self.init_noise_sigma = 1.0

    @classmethod
    def from_config_file(cls, path: str) -> "DDIMScheduler":
        """Build from a diffusers ``scheduler_config.json``. A prediction
        type other than epsilon / v_prediction raises; other fields that
        would change the semantics and are not implemented get a warning."""
        with open(path) as f:
            cfg = json.load(f)
        if cfg.get("clip_sample", False):
            log.warning("scheduler_config clip_sample=true is not implemented; "
                        "denoising proceeds without x0 clipping")
        if cfg.get("steps_offset", 0):
            log.warning("scheduler_config steps_offset=%s ignored (timesteps() uses "
                        "the trailing schedule)", cfg["steps_offset"])
        if cfg.get("timestep_spacing", "trailing") != "trailing":
            log.warning("scheduler_config timestep_spacing=%r ignored (trailing "
                        "schedule is used)", cfg["timestep_spacing"])
        if cfg.get("set_alpha_to_one", True) is False:
            log.warning("scheduler_config set_alpha_to_one=false ignored (final "
                        "alpha_prev is fixed at 1.0)")
        if cfg.get("rescale_betas_zero_snr", False):
            log.warning("scheduler_config rescale_betas_zero_snr=true is not "
                        "implemented; the beta schedule is NOT zero-SNR rescaled")
        if cfg.get("thresholding", False):
            log.warning("scheduler_config thresholding=true is not implemented")
        return cls(
            num_train_timesteps=cfg.get("num_train_timesteps", 1000),
            beta_start=cfg.get("beta_start", 0.00085),
            beta_end=cfg.get("beta_end", 0.012),
            beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
            prediction_type=cfg.get("prediction_type", "epsilon"),
        )

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """Descending inference timestep schedule (int64, on the CPU)."""
        step = self.num_train_timesteps // num_inference_steps
        return torch.arange(self.num_train_timesteps - 1, -1, -step)[:num_inference_steps]

    def _alpha(self, t: int, like: torch.Tensor) -> torch.Tensor:
        return self.alphas_cumprod[int(t)].to(like.device)

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        a = self._alpha(t, sample)
        return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise

    def step(self, model_out: torch.Tensor, t, sample: torch.Tensor, prev_t) -> torch.Tensor:
        """One deterministic DDIM update x_t -> x_{prev_t} (prev_t < 0: the
        end, alpha_prev 1). ``model_out`` is an epsilon or a v prediction
        (v = sqrt(a) eps - sqrt(1-a) x0, Salimans & Ho 2022)."""
        a_t = self._alpha(t, sample)
        a_prev = (self._alpha(prev_t, sample) if int(prev_t) >= 0
                  else torch.ones((), device=sample.device))
        if self.prediction_type == "v_prediction":
            sq_a, sq_1a = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
            x0 = sq_a * sample - sq_1a * model_out
            eps = sq_a * model_out + sq_1a * sample
        else:
            eps = model_out
            x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
