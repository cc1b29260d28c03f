"""Training step + optimizer: render -> loss -> backward -> Adam -> grad accumulator.

Torch port of ``tinysplat_tpu.train``. PyTorch runs eagerly, so the step is
a Python function, not one compiled executable; it adds no host sync of its
own (metrics stay device tensors, the step count is a host int).

- The loss is ``(1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM)``, plus the
  depth and opacity-entropy regularizers behind their step windows, and the
  MCMC sparsity terms when ``densify_strategy="mcmc"``.
- ``loss.backward()`` reaches the compositing backward kernel K2 and the
  ``grad_reduce`` reduction through ``rasterize_cuda``, then autograd through
  the depth-order permutation, projection, SH and the opacity sigmoid.
- Adam has torch semantics (betas 0.9 / 0.999, eps 1e-8 outside the sqrt),
  one param group per ``GaussianParams`` field with its own learning rate,
  and the optional log-linear means-LR decay. The optimizer updates the
  state's parameter tensors IN PLACE (the JAX step returns new arrays); the
  returned state holds those same tensors.
- The densify signal ``means_grad_accum`` adds ||dL/d xys|| per step once
  ``step >= warmup_grad``.
- ``pose_opt`` / ``app_opt``: a per-camera SE(3) delta
  (``cameras.apply_pose_delta``) and an affine colour transform of the
  render (``apply_appearance``) take part in the loss; the step returns
  their gradients as ``metrics["pose_grad"]`` (6,) and
  ``metrics["app_grad"]`` (12,), and the trainer runs their Adams.
- Densify, growth and compaction keep the optimizer valid: in-place edits
  go through ``GaussianAdam.moment_pairs``, new tensors through
  ``GaussianAdam.carried`` (``models/densify.py``, ``models/gaussians.py``).
- ``regularize_density``: the SuGaR density term against the trainer's
  cached ``DensityProbe`` (``regularizers/density.py``) reaches the
  compositing backward through the depth channel of the render and the
  scales through ``probe_beta``.
- ``densify_strategy="mcmc"``: after Adam, the means get the MCMC position
  noise (``models/densify_mcmc.inject_noise``), scaled by
  ``mcmc_noise_lr`` x the step's means learning rate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cameras import CameraParams, apply_pose_delta
from .config import Config
from .models.gaussians import GaussianParams, GaussianState
from .ops.ssim import psnr, ssim
from .render import render
from .utils.profiling import span

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _resolve_background(cfg: Config, generator: Optional[torch.Generator] = None,
                        device="cpu") -> torch.Tensor:
    """Per-step training background: the fixed colour the GT frames were
    composited onto (cfg.background "white"/"black"), else uniform random
    from ``generator`` (a ``torch.Generator`` on ``device``)."""
    if cfg.background == "white":
        return torch.ones(3, device=device)
    if cfg.background == "black":
        return torch.zeros(3, device=device)
    return torch.rand(3, generator=generator, device=device)


def fixed_background(cfg: Config, device="cpu") -> torch.Tensor:
    """Eval/viewer background: the fixed training colour, black otherwise."""
    return torch.ones(3, device=device) if cfg.background == "white" else torch.zeros(
        3, device=device)


def lr_tree(cfg: Config) -> Dict[str, float]:
    """Per-field learning rates, in the JAX package's leaf order."""
    return {
        "means": cfg.lr_means,
        "colors_dc": cfg.lr_colors_dc,
        "colors_rest": cfg.lr_colors_rest,
        "scales": cfg.lr_scales,
        "quats": cfg.lr_quats,
        "opacities": cfg.lr_opacities,
    }


def means_lr_at(cfg: Config, step: int) -> float:
    """The means learning rate at ``step``: log-linear from lr_means to
    lr_means_final over lr_means_decay_steps (default max_iter) when
    lr_means_final > 0, else constant."""
    decay_steps = cfg.lr_means_decay_steps or cfg.max_iter
    if cfg.lr_means_final > 0.0 and decay_steps > 0:
        log_ratio = math.log(cfg.lr_means_final / cfg.lr_means)
        frac = min(max(step / decay_steps, 0.0), 1.0)
        return cfg.lr_means * math.exp(log_ratio * frac)
    return cfg.lr_means


class GaussianAdam(torch.optim.Adam):
    """``torch.optim.Adam`` with one param group per ``GaussianParams``
    field (means first) at its ``lr_tree`` learning rate. Before each step
    the means group's rate is set to ``means_lr_at`` of the optimizer's own
    count, read before its increment (as the JAX package's schedule does)."""

    def __init__(self, cfg: Config, params: GaussianParams):
        lrs = lr_tree(cfg)
        super().__init__(
            [{"params": [t], "lr": lrs[name], "name": name} for name, t in params.fields()],
            betas=ADAM_BETAS, eps=ADAM_EPS)
        self.cfg = cfg

    @property
    def count(self) -> int:
        """Adam steps taken (every field steps together)."""
        state = self.state.get(self.param_groups[0]["params"][0])
        return int(state["step"]) if state else 0

    def step(self, closure=None):
        self.param_groups[0]["lr"] = means_lr_at(self.cfg, self.count)
        return super().step(closure)

    def moment_pairs(self) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor]]:
        """(field name, exp_avg, exp_avg_sq) of every field that has taken a
        step: the optimizer's own tensors, for in-place edits (densify,
        prune, opacity reset)."""
        for group in self.param_groups:
            st = self.state.get(group["params"][0])
            if st:
                yield group["name"], st["exp_avg"], st["exp_avg_sq"]

    def moments(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], int]:
        """(first moments, second moments, count), the moments by field name:
        the optimizer's own tensors, or zeros for a field not stepped yet."""
        mu, nu = {}, {}
        for group in self.param_groups:
            t, name = group["params"][0], group["name"]
            st = self.state.get(t)
            mu[name] = st["exp_avg"] if st else torch.zeros_like(t).detach()
            nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(t).detach()
        return mu, nu, self.count

    def carried(self, params: GaussianParams,
                moment_fn: Callable[[torch.Tensor], torch.Tensor] = lambda m: m
                ) -> "GaussianAdam":
        """An optimizer of ``params`` (new tensors: after capacity growth,
        compaction or a rollback) with this one's moments mapped through
        ``moment_fn`` and its count kept.

        torch's Adam keys its state by tensor identity, so new parameter
        tensors need a new optimizer; this is the one place that builds it.
        """
        mu, nu, count = self.moments()
        return optimizer_with_moments(self.cfg, params,
                                      {k: moment_fn(v) for k, v in mu.items()},
                                      {k: moment_fn(v) for k, v in nu.items()}, count)


def make_optimizer(cfg: Config, params: GaussianParams) -> GaussianAdam:
    """Adam over ``params``' six fields (made trainable leaves here), torch
    semantics: betas (0.9, 0.999), eps 1e-8 added outside the sqrt."""
    return GaussianAdam(cfg, params.requires_grad_())


def init_opt_state(cfg: Config, state: GaussianState) -> GaussianAdam:
    """The optimizer of ``state``'s parameters, with empty moments."""
    return make_optimizer(cfg, state.params)


def optimizer_with_moments(cfg: Config, params: GaussianParams,
                           mu: Mapping[str, Any], nu: Mapping[str, Any],
                           count: int) -> GaussianAdam:
    """An optimizer of ``params`` holding first and second moments ``mu`` /
    ``nu`` (field name -> tensor or array, copied onto each field's device)
    and the update ``count``."""
    def copy(m, like):
        if torch.is_tensor(m):
            return m.to(like.device, torch.float32, copy=True)
        return torch.tensor(np.asarray(m, np.float32), device=like.device)

    opt = make_optimizer(cfg, params)
    for name, t in params.fields():
        opt.state[t] = {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": copy(mu[name], t), "exp_avg_sq": copy(nu[name], t)}
    return opt


def opt_state_from_jax(cfg: Config, state: GaussianState, mu: Mapping[str, np.ndarray],
                       nu: Mapping[str, np.ndarray], count: int) -> GaussianAdam:
    """Carry the JAX package's optax Adam state across: first and second
    moments ``mu`` / ``nu`` (field name -> numpy array) and the update
    ``count``, onto an optimizer of ``state``'s parameters."""
    return optimizer_with_moments(cfg, state.params, mu, nu, count)


class StepOutput(NamedTuple):
    state: GaussianState
    opt_state: Any
    metrics: Dict[str, Any]
    rendered: torch.Tensor  # (H, W, 3), detached


def apply_appearance(rgb: torch.Tensor, app_params: torch.Tensor) -> torch.Tensor:
    """Per-camera affine exposure compensation (``app_opt``).

    app_params (12,) = a flattened 3x3 delta from the identity + a 3-bias:
    rgb' = clip(rgb @ (I + A)^T + b, 0, 1). Zero params are the identity.
    Applied to the RENDERED image inside the training loss only.
    """
    A = torch.eye(3, dtype=rgb.dtype, device=rgb.device) + app_params[:9].reshape(3, 3)
    return torch.clamp(rgb @ A.T + app_params[9:], 0.0, 1.0)


def _schedule_gate(active: bool, start: int, stop: int, step: int) -> float:
    """Window gate of the reference Scheduler: 1 inside [start, stop)."""
    return 1.0 if active and start <= step < stop else 0.0


def compute_losses(
    params: GaussianParams,
    probe: Optional[torch.Tensor],
    state: GaussianState,
    camera: CameraParams,
    gt_image: torch.Tensor,
    est_depth: Optional[torch.Tensor],
    background: torch.Tensor,
    step: int,
    cfg: Config,
    img_height: int,
    img_width: int,
    density_probe=None,
    pose_delta=None,
    app_params=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Total loss + aux dict (the JAX package's loss stack)."""
    if pose_delta is not None:  # pose_opt: refine the view by an SE(3) delta
        camera = apply_pose_delta(camera, pose_delta)
    rgb, extras = render(
        params, state.alive, camera, img_height, img_width, state.active_sh_degree,
        background, rasterizer=cfg.rasterizer, xys_probe=probe,
        viewdirs_mode=cfg.viewdirs_mode, tile_size=cfg.tile_size,
        dup_capacity=cfg.dup_capacity, max_per_tile=cfg.max_per_tile,
        span_capacity=cfg.span_capacity, grad_reduce=cfg.grad_reduce,
        tiles_per_block=cfg.tiles_per_block, tile_x=cfg.tile_x,
        antialiased=cfg.antialiased,
    )
    with span("ts.train_step.loss"):
        if app_params is not None:  # app_opt: exposure compensation, loss only
            rgb = apply_appearance(rgb, app_params)
        loss_l1 = torch.mean(torch.abs(rgb - gt_image))
        loss_ssim = 1.0 - ssim(rgb, gt_image)
        loss = (1.0 - cfg.lambda_dssim) * loss_l1 + cfg.lambda_dssim * loss_ssim

        aux: Dict[str, Any] = {
            "loss_l1": loss_l1,
            "loss_ssim": loss_ssim,
            "rgb": rgb,
            "depth": extras["depth"],
            "alpha": extras["alpha"],
        }
        if "binning" in extras:
            aux["n_intersections"] = extras["binning"]["intersections"]
            aux["n_dup_dropped"] = extras["binning"]["dup_dropped"]
            aux["n_tile_dropped"] = extras["binning"]["tile_dropped"]

        if cfg.regularize_depth and est_depth is not None:
            gate = _schedule_gate(True, cfg.regularize_depth_start, cfg.regularize_depth_end, step)
            loss_depth = torch.mean(torch.abs(extras["depth"] - est_depth))
            loss = loss + gate * cfg.lambda_depth * loss_depth
            aux["loss_depth"] = loss_depth

        if cfg.regularize_opacity:  # opacity entropy, over live splats only
            gate = _schedule_gate(True, cfg.regularize_opacity_start,
                                  cfg.regularize_opacity_end, step)
            o = torch.sigmoid(params.opacities.reshape(-1))
            ent = -(o * torch.log(o + 1e-10) + (1 - o) * torch.log(1 - o + 1e-10))
            n_live = torch.clamp(state.alive.sum(), min=1)
            loss_opacity = torch.where(state.alive, ent, 0.0).sum() / n_live
            loss = loss + gate * cfg.lambda_opacity * loss_opacity
            aux["loss_opacity"] = loss_opacity

        # SuGaR density / SDF term against the cached probe.
        if cfg.regularize_density and density_probe is not None:
            from .regularizers.density import density_loss

            gate = _schedule_gate(True, cfg.regularize_density_start,
                                  cfg.regularize_density_end, step)
            with span("ts.train_step.density"):
                loss_density = density_loss(density_probe, params, extras["depth"], camera,
                                            img_height, img_width, use_sdf=cfg.regularize_sdf)
            loss = loss + gate * cfg.lambda_density * loss_density
            aux["loss_density"] = loss_density

        if cfg.densify_strategy == "mcmc":  # 3DGS-MCMC sparsity regularizers
            with span("ts.train_step.mcmc_sparsity"):
                n_live = torch.clamp(state.alive.sum(), min=1)
                if cfg.lambda_mcmc_opacity > 0:
                    o = torch.sigmoid(params.opacities.reshape(-1))
                    loss_mo = torch.where(state.alive, o, 0.0).sum() / n_live
                    loss = loss + cfg.lambda_mcmc_opacity * loss_mo
                    aux["loss_mcmc_opacity"] = loss_mo
                if cfg.lambda_mcmc_scale > 0:
                    s = torch.exp(params.scales)
                    loss_ms = torch.where(state.alive[:, None], s, 0.0).sum() / (3 * n_live)
                    loss = loss + cfg.lambda_mcmc_scale * loss_ms
                    aux["loss_mcmc_scale"] = loss_ms

    return loss, aux


def make_train_step(cfg: Config, img_height: int, img_width: int):
    """Build the train step for a given image shape.

    ``train_step(state, opt_state, camera, gt_image, est_depth, step,
    generator=None, background=None, pose_delta=None, app_params=None,
    density_probe=None, noise_eps=None)`` runs one step and returns a
    ``StepOutput``. ``opt_state`` is the optimizer of ``state``'s
    parameters (``init_opt_state`` / ``opt_state_from_jax``), which it
    updates in place. ``background`` overrides the cfg's background (tests
    pass the JAX package's draw); ``generator`` draws the random one, and
    the MCMC noise when ``noise_eps`` (C, 3) is not given. Under
    ``cfg.pose_opt`` / ``cfg.app_opt`` a given ``pose_delta`` (6,) /
    ``app_params`` (12,) enters the loss and its gradient is returned in
    the metrics; under ``cfg.regularize_density`` a given ``density_probe``
    enters the loss.
    """
    def train_step(state: GaussianState, opt_state: GaussianAdam, camera: CameraParams,
                   gt_image: torch.Tensor, est_depth: Optional[torch.Tensor], step: int,
                   generator: Optional[torch.Generator] = None,
                   background: Optional[torch.Tensor] = None,
                   pose_delta: Optional[torch.Tensor] = None,
                   app_params: Optional[torch.Tensor] = None,
                   density_probe=None,
                   noise_eps: Optional[torch.Tensor] = None) -> StepOutput:
        with span("ts.train_step"):
            step = int(step)
            for (name, t), group in zip(state.params.fields(), opt_state.param_groups):
                if group["params"][0] is not t:
                    raise ValueError(f"opt_state does not update state.params.{name}: build it "
                                     "with init_opt_state(cfg, state)")
            dev = gt_image.device
            # SH degree warm-up: +1 every sh_increment_interval steps, capped.
            active_deg = min(cfg.sh_degree, 1 + step // cfg.sh_increment_interval)
            state = dataclasses.replace(
                state, active_sh_degree=torch.tensor(active_deg, dtype=torch.int32, device=dev))
            if background is None:
                background = _resolve_background(cfg, generator, dev)

            probe = torch.zeros((state.capacity, 2), dtype=gt_image.dtype, device=dev,
                                requires_grad=True)
            # The camera-side leaves: gradients for the trainer's pose / app Adams.
            pose = (pose_delta.detach().clone().requires_grad_()
                    if cfg.pose_opt and pose_delta is not None else None)
            app = (app_params.detach().clone().requires_grad_()
                   if cfg.app_opt and app_params is not None else None)
            opt_state.zero_grad(set_to_none=True)
            with span("ts.train_step.forward"):
                loss, aux = compute_losses(state.params, probe, state, camera, gt_image,
                                           est_depth, background, step, cfg, img_height,
                                           img_width, density_probe=density_probe,
                                           pose_delta=pose, app_params=app)
            with span("ts.train_step.backward"):
                loss.backward()
            opt_state.step()  # inside torch's own Optimizer.step#GaussianAdam.step range
            with span("ts.train_step.accum"):
                if cfg.densify_strategy == "mcmc":
                    from .models import densify_mcmc

                    lr_scaler = cfg.mcmc_noise_lr * means_lr_at(cfg, step)
                    with span("ts.train_step.mcmc_noise"):
                        if noise_eps is None:
                            densify_mcmc.inject_noise(state.params, state.alive, lr_scaler,
                                                      cfg, generator)
                        else:
                            densify_mcmc.apply_noise(state.params, state.alive, noise_eps,
                                                     lr_scaler, cfg)

                # Densification signal: ||dL/d(screen xy)|| past the warm-up.
                accum = state.means_grad_accum
                if step >= cfg.warmup_grad:
                    accum = accum + torch.linalg.norm(probe.grad, dim=-1)
                new_state = dataclasses.replace(state, means_grad_accum=accum)

                metrics = {
                    "loss": loss.detach(),
                    "loss_l1": aux["loss_l1"].detach(),
                    "loss_ssim": aux["loss_ssim"].detach(),
                    "psnr": psnr(aux["rgb"].detach(), gt_image),
                    "num_live": new_state.num_live(),
                }
                for k in ("loss_depth", "loss_opacity", "loss_density", "loss_mcmc_opacity",
                          "loss_mcmc_scale", "n_intersections", "n_dup_dropped",
                          "n_tile_dropped"):
                    if k in aux:
                        v = aux[k]
                        metrics[k] = v.detach() if torch.is_tensor(v) else v
                if pose is not None:
                    metrics["pose_grad"] = pose.grad  # (6,); the trainer runs its Adam
                if app is not None:
                    metrics["app_grad"] = app.grad  # (12,)
                return StepOutput(new_state, opt_state, metrics, aux["rgb"].detach())

    return train_step

