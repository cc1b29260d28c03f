"""Offline monocular depth estimation + SfM scale alignment (a copy of
``tinysplat_tpu.depthest``; the port imports nothing of the JAX package).

Host-side subsystem with the contract of the reference DepthEstimator
(its tinysplat/depth.py:11-65): per-camera dense depth maps,
cached as <depths_path>/<camera.name>.npy, aligned to the COLMAP sparse
reconstruction's metric scale, stored on camera.estimated_depth for the
depth-guided regularizer (Chung et al.; reference scripts/train.py:65-69).

Reference bugs fixed here (SURVEY.md section 2.1):
- depth.py:61 compares a string to a list (`name == ["midas"]`), so the
  disparity-space alignment path can never run — here backends declare
  `space` ("depth" | "disparity") and dispatch on it;
- the DepthAnything backend (depth.py:172-201) references undefined
  names (`Compose`, `transform`, `model`) and would crash — here it uses the
  HF transformers depth-estimation pipeline.
"""
from .estimator import DepthEstimator
from .align import match_scale, match_scale_disparity
from .sparse import estimate_sparse

__all__ = ["DepthEstimator", "match_scale", "match_scale_disparity", "estimate_sparse"]
