"""Diffusion-guided novel-view regularization (ReconFusion-flavoured).

Torch port of ``tinysplat_tpu.regularizers.diffusion_guidance``. Every
``interval_diffusion`` steps inside the schedule window, novel cameras are
synthesized between random pairs of training views; the current model
renders each (the SDEdit-style init image, through K1), the diffusion
pipeline refines it at ``diffusion_strength``, conditioned on the two
neighbouring real views, and the refined frames become synthetic training
cameras appended to the scene. The regular loss then distills the
diffusion prior into the splats at those poses, so the train step does not
change; the effective weight is the synthetic / real view ratio
(``lambda_diffusion``). Single-device ``Trainer`` only: synthetic views are
square at the pipeline's resolution, and ``MeshTrainer`` needs one image
shape.

The host draws come from ``np.random.default_rng(seed)`` in the JAX
package's order (the pair, t, then the integer that seeds the pipeline's
draws), so both packages synthesize the same cameras.
"""
from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from ..cameras import Camera
from ..utils.resize import resize

log = logging.getLogger(__name__)

# Seed of the random-init fallback pipeline (the JAX package's PRNGKey(7)).
FALLBACK_SEED = 7


def _rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """Shepperd's method; w first, as utils.quaternions."""
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                      (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
        q = np.empty(4)
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    return q / np.linalg.norm(q)


def _cam_quat(cam: Camera) -> np.ndarray:
    return _rotmat_to_quat(np.asarray(cam.view_matrix)[:3, :3])


def _slerp(qa: np.ndarray, qb: np.ndarray, t: float) -> np.ndarray:
    qa = qa / np.linalg.norm(qa)
    qb = qb / np.linalg.norm(qb)
    d = float(np.dot(qa, qb))
    if d < 0.0:
        qb, d = -qb, -d
    if d > 0.9995:
        q = qa + t * (qb - qa)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - t) * th) * qa + np.sin(t * th) * qb) / np.sin(th)


def interpolate_camera(cam_a: Camera, cam_b: Camera, t: float, size: int,
                       name: str) -> Camera:
    """Novel pose between two training views, at the pipeline's square
    resolution (intrinsics rescaled accordingly)."""
    pos = (1 - t) * cam_a.position + t * cam_b.position
    quat = _slerp(_cam_quat(cam_a), _cam_quat(cam_b), t)
    sx, sy = size / cam_a.width, size / cam_a.height
    return Camera(position=pos, f_x=cam_a.f_x * sx, f_y=cam_a.f_y * sy, fov_x=cam_a.fov_x,
                  fov_y=cam_a.fov_y, quat=quat, width=size, height=size, name=name)


class DiffusionGuidance:
    """Owns the pipeline (built once, reused) and the synthetic camera set;
    refreshed on cadence."""

    def __init__(self, cfg, rng_seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.size: Optional[int] = None
        self.pipeline = None
        self.cameras: List[Camera] = []
        self._rng = np.random.default_rng(rng_seed)

    def _ensure_pipeline(self):
        if self.pipeline is not None:
            return
        from ..diffusion.pipeline import TinysplatDiffusionPipeline

        if self.cfg.diffusion_model_dir:
            self.pipeline = TinysplatDiffusionPipeline.from_pretrained(
                self.cfg.diffusion_model_dir, device=self.device)
        else:
            # No checkpoint: a tiny random-init pipeline runs the whole
            # wiring (it preserves structure at moderate strength, since
            # denoising starts from the model's own render).
            self.pipeline = TinysplatDiffusionPipeline.tiny(
                generator=torch.Generator().manual_seed(FALLBACK_SEED), device=self.device)
            log.warning("regularize_diffusion: no --diffusion-model-dir given; using a tiny "
                        "random-init pipeline (wiring check, not a real prior)")
        self.size = self.pipeline.unet.sample_size * 8

    def refine(self, init, cam_tg, cam_in, input_imgs, seed: int) -> torch.Tensor:
        """The pipeline on one novel view, its draws from ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.pipeline(init, cam_tg, cam_in, input_imgs,
                             num_inference_steps=self.cfg.diffusion_inference_steps,
                             strength=self.cfg.diffusion_strength, generator=gen)

    def refresh(self, trainer, real_cams: List[Camera]) -> List[Camera]:
        """(Re)generate the synthetic view set from the current model."""
        from ..diffusion.pipeline import stack_cameras

        self._ensure_pipeline()
        cfg, s, dev = self.cfg, self.size, self.device
        n_synth = max(1, int(round(cfg.lambda_diffusion * len(real_cams))))
        fe = self.pipeline.feature_encoder
        # The conditioning views feed the feature encoder at ITS resolution.
        s_fe = fe.sample_size if fe is not None else s
        new_cams: List[Camera] = []
        for i in range(n_synth):
            ia = int(self._rng.integers(len(real_cams)))
            ib = (ia + 1) % len(real_cams)
            t = float(self._rng.uniform(0.3, 0.7))
            novel = interpolate_camera(real_cams[ia], real_cams[ib], t, s, name=f"diffusion_{i}")
            # SDEdit init: the model's own render of the novel pose.
            rgb, _ = trainer.render_camera(novel, dims=(s, s))
            init = rgb.permute(2, 0, 1)[None] * 2.0 - 1.0
            inputs = []
            for c in (real_cams[ia], real_cams[ib]):
                img = torch.as_tensor(c.get_original_image((c.width, c.height)),
                                      dtype=torch.float32, device=dev)
                inputs.append(resize(img.permute(2, 0, 1), (s_fe, s_fe), "linear"))
            input_imgs = torch.stack(inputs)[None]  # (1, 2, 3, S, S)
            cam_in = stack_cameras([[real_cams[ia], real_cams[ib]]], dev)  # (1, 2)
            cam_tg = stack_cameras([novel], dev)
            out = self.refine(init, cam_tg, cam_in, input_imgs,
                              int(self._rng.integers(1 << 31)))
            novel._image = torch.clamp((out[0].permute(1, 2, 0) + 1.0) / 2.0, 0.0,
                                       1.0).cpu().numpy().astype(np.float32)
            new_cams.append(novel)
        self.cameras = new_cams
        return new_cams
