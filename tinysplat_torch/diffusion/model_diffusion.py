"""PixelNeRF-style feature-volume conditioning.

Torch port of ``tinysplat_tpu.diffusion.model_diffusion``:

- ``FeatureVolumeEncoder``: UNet-encode N input views into per-view feature
  maps; cast rays through the target camera; sample points along each ray
  linearly in disparity; reproject the points onto every input view and
  trilinearly sample pixel-aligned features; downsample to (C, D, D)
  volumes.
- ``FeatureAggregator``: positional-encode the reprojected coordinates, run
  a per-(view, pixel) MLP, sum over views with sigmoid weights, a second
  MLP to (C + 3, D, D).
- ``EmbeddingMLP``: project concatenated CLIP text + image embeddings into
  2 cross-attention tokens.

Cameras arrive as batched ``CameraParams`` (tensors with leading (B,) or
(B, N) axes) and images as tensors.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..cameras import CameraParams
from ..utils.rays import unproj_map
from ..utils.resize import resize
from .unet import UNet2D, auto_names

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _trilinear_border(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of (D0, D1, D2) ``volume`` at float ``coords``
    (P, 3) in index space, border-clamped (grid_sample with
    padding_mode='border', align_corners=True). A NaN coordinate gives a
    NaN sample."""
    shape = torch.tensor(volume.shape, dtype=torch.float32, device=volume.device)
    c = torch.minimum(torch.clamp(coords, min=0.0), shape - 1.0)
    lo = torch.floor(c)
    f = c - lo
    # NaN coordinates read slot 0; their NaN weights carry into the sample.
    lo = torch.nan_to_num(lo, nan=0.0).long()
    hi = torch.minimum(lo + 1, torch.tensor(volume.shape, device=volume.device) - 1)
    idx = (lo, hi)
    out = 0.0
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                w = ((f[:, 0] if i else 1 - f[:, 0]) * (f[:, 1] if j else 1 - f[:, 1])
                     * (f[:, 2] if k else 1 - f[:, 2]))
                out = out + w * volume[idx[i][:, 0], idx[j][:, 1], idx[k][:, 2]]
    return out


def project_points_ndc(cam: CameraParams, points: torch.Tensor) -> torch.Tensor:
    """World points (..., P, 3) -> (ndc_x, ndc_y, clip_z) through cameras
    whose matrices have the points' leading axes: (..., 4, 4)."""
    view, proj = cam.viewmat, cam.projmat
    camp = points @ view[..., :3, :3].transpose(-1, -2) + view[..., None, :3, 3]
    hom = torch.cat([camp, torch.ones_like(camp[..., :1])], dim=-1) @ proj.transpose(-1, -2)
    w = hom[..., 3:4]
    xy = hom[..., :2] / torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)
    return torch.cat([xy, hom[..., 2:3]], dim=-1)


class FeatureVolumeEncoder(nn.Module):
    """UNet image encoder + ray-sampled, reprojected feature volumes."""

    def __init__(self, sample_size: int = 64, num_channels: int = 32, latent_dim: int = 16,
                 unet_block_out_channels: Sequence[int] = (32, 64), z_near: float = 0.1,
                 z_far: float = 100.0):
        super().__init__()
        self.sample_size, self.num_channels, self.latent_dim = (sample_size, num_channels,
                                                                latent_dim)
        self.z_near, self.z_far = z_near, z_far
        self.encoder = UNet2D(sample_size=sample_size, in_channels=3, out_channels=num_channels,
                              block_out_channels=unet_block_out_channels)

    def flax_children(self):
        return [("encoder", self.encoder)]

    def forward(self, target_cams: CameraParams, input_images: torch.Tensor,
                input_cams: CameraParams) -> Tuple[torch.Tensor, torch.Tensor]:
        """target_cams batched (B,), input_images (B, N, 3, S, S) in [0, 1],
        input_cams batched (B, N) -> features (B, N, C, D, D) and
        coordinates (B, N, 3, C, D, D)."""
        B, N = input_images.shape[:2]
        S, C, D = self.sample_size, self.num_channels, self.latent_dim
        dev = input_images.device
        feats = self.encoder(input_images.reshape(B * N, 3, S, S), torch.ones((1,), device=dev))
        feats = feats.reshape(B, N, C, S, S)

        # Rays through the target cameras. The focal length of the S x S ray
        # grid comes from the projection matrix (1 / tan(fov / 2)), so it
        # does not depend on the camera's resolution.
        origins, dirs = [], []
        for b in range(B):
            fx_s = target_cams.projmat[b, 0, 0] * S / 2
            fy_s = target_cams.projmat[b, 1, 1] * S / 2
            dirs_cam = unproj_map(S, S, fx_s, fy_s)
            r_inv = torch.linalg.inv(target_cams.viewmat[b, :3, :3])
            d = -(dirs_cam.reshape(-1, 3) @ r_inv.T)
            dirs.append(d / torch.linalg.norm(d, dim=-1, keepdim=True))
            origins.append(target_cams.cam_pos[b].expand(d.shape))
        origins, dirs = torch.stack(origins), torch.stack(dirs)  # (B, S*S, 3)

        # Depth samples linear in disparity.
        steps = torch.linspace(0.0, 1.0 - 1.0 / C, C, device=dev)
        z_samp = 1.0 / (1.0 / self.z_near * (1 - steps) + 1.0 / self.z_far * steps)
        points = origins[:, :, None, :] + z_samp[None, None, :, None] * dirs[:, :, None, :]
        xyz = project_points_ndc(input_cams, points.reshape(B, 1, -1, 3))  # (B, N, P, 3)

        # Pixel-aligned trilinear lookup; the channel axis is the volume's
        # depth axis, as in the reference.
        z_min, z_max = z_samp[0], z_samp[-1]
        sampled = torch.empty((B, N, xyz.shape[2]), device=dev)
        for b in range(B):
            for n in range(N):
                co = xyz[b, n]
                zc = 2 * (co[:, 2] - z_min) / torch.clamp(z_max - z_min, min=1e-9) - 1
                ic = torch.stack([(zc * 0.5 + 0.5) * (C - 1),
                                  (co[:, 1] * 0.5 + 0.5) * (S - 1),
                                  (co[:, 0] * 0.5 + 0.5) * (S - 1)], dim=1)
                sampled[b, n] = _trilinear_border(feats[b, n], ic)
        sampled = sampled.reshape(B, N, S, S, C)

        feats_p = resize(torch.movedim(sampled, -1, 2), (D, D), "linear")
        xyz_vol = xyz.reshape(B, N, S, S, C, 3).permute(0, 1, 5, 4, 2, 3)  # (B, N, 3, C, S, S)
        xyz_vol = torch.nan_to_num(resize(xyz_vol, (D, D), "linear"))
        return feats_p, xyz_vol


class FeatureAggregator(nn.Module):
    """Sigmoid-weighted view aggregation."""

    def __init__(self, input_dim: int = 32, hidden_dim: int = 64, code_len: int = 10):
        super().__init__()
        self.input_dim, self.hidden_dim, self.code_len = input_dim, hidden_dim, code_len
        code = input_dim * (6 * code_len if code_len else 3)
        self.fc1 = nn.Linear(input_dim + code, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, 2 * input_dim)
        self.fc3 = nn.Linear(input_dim, hidden_dim)
        self.fc4 = nn.Linear(hidden_dim, input_dim + 3)

    def flax_children(self):
        return auto_names([("Dense", m) for m in (self.fc1, self.fc2, self.fc3, self.fc4)])

    def forward(self, features: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        B, N, C, D, _ = features.shape
        code = self._positional_encode(xyz)
        f = features.permute(0, 1, 3, 4, 2).reshape(-1, C)
        h = self.fc2(self.fc1(torch.cat([f, code], dim=1)))
        tmp = F.silu(h[:, :self.input_dim]) * torch.sigmoid(h[:, self.input_dim:])
        tmp = tmp.reshape(B, N, D, D, C).sum(dim=1)
        out = self.fc4(F.silu(self.fc3(tmp)))
        return out.permute(0, 3, 1, 2)  # (B, C + 3, D, D)

    def _positional_encode(self, xyz: torch.Tensor) -> torch.Tensor:
        C = xyz.shape[3]
        comps = xyz.permute(2, 0, 1, 4, 5, 3).reshape(3, -1, C)
        if self.code_len == 0:
            return torch.cat([comps[0], comps[1], comps[2]], dim=1)
        outs = []
        for t in comps:
            enc = [torch.sin((2.0**i) * t * math.pi) for i in range(self.code_len)]
            enc += [torch.cos((2.0**i) * t * math.pi) for i in range(self.code_len)]
            outs.append(torch.cat(enc, dim=1))
        return torch.cat(outs, dim=1)


class EmbeddingMLP(nn.Module):
    """CLIP text + image embeds -> 2 cross-attention tokens."""

    def __init__(self, conditioned_images: int = 3, embed_dim: int = 768):
        super().__init__()
        self.conditioned_images, self.embed_dim = conditioned_images, embed_dim
        self.proj = nn.Linear((2 + conditioned_images) * embed_dim, 2 * embed_dim)

    def flax_children(self):
        return [("Dense_0", self.proj)]

    def forward(self, text_embeds: torch.Tensor, image_embeds: torch.Tensor) -> torch.Tensor:
        B = image_embeds.shape[0]
        x = torch.cat([text_embeds, image_embeds], dim=1).reshape(B, -1)
        return self.proj(x).reshape(B, 2, self.embed_dim)


def clip_preprocess(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW images -> CLIP-normalized 224 x 224."""
    x = (resize(images, (224, 224), "cubic") + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std
