"""Semantic segmentation sidecar (Mask2Former per-camera semantic maps).

A copy of ``tinysplat_tpu.semantic`` (numpy only; it never imported JAX):
the same cache-or-compute contract as the depth estimator. Maps are cached
as ``<semantic_path>/<sanitized camera name>.npy`` (the depth estimator's
``_cache_key``) and loaded when present; otherwise the backend computes
them. The backend is injectable (a callable taking a camera, or an object
with ``predict(camera)``), so the logic is testable without downloading
weights; a model id string loads the Hugging Face Mask2Former on first use.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Union

import numpy as np

log = logging.getLogger(__name__)


class Mask2FormerBackend:
    """Hugging Face Mask2Former semantic segmentation, loaded from ``model_id``."""

    def __init__(self, model_id: str = "facebook/mask2former-swin-large-ade-semantic"):
        from transformers import (
            AutoImageProcessor,
            Mask2FormerForUniversalSegmentation,
        )

        self.processor = AutoImageProcessor.from_pretrained(model_id)
        self.model = Mask2FormerForUniversalSegmentation.from_pretrained(model_id)

    def predict(self, camera) -> np.ndarray:
        import torch
        from PIL import Image

        img = camera.get_original_image()
        pil = Image.fromarray((img * 255).astype(np.uint8))
        inputs = self.processor(images=pil, return_tensors="pt")
        with torch.no_grad():
            outputs = self.model(**inputs)
        seg = self.processor.post_process_semantic_segmentation(
            outputs, target_sizes=[pil.size[::-1]]
        )[0]
        return np.asarray(seg, np.int32)


class SemanticSegmenter:
    def __init__(
        self,
        scene,
        semantic_path: str = "semantic",
        model: Union[str, Callable, None] = "facebook/mask2former-swin-large-ade-semantic",
        skip_init: bool = False,
        **_unused,
    ):
        self.scene = scene
        self.semantic_path = semantic_path
        self.backend = model if not isinstance(model, str) else None
        self._model_id = model if isinstance(model, str) else None

        os.makedirs(semantic_path, exist_ok=True)
        if skip_init:
            return
        # Same sanitized-name, lazy-load cache discipline as the depth
        # estimator (camera names are relative paths).
        from .depthest.estimator import _cache_key

        stored = {f[:-4] for f in os.listdir(semantic_path)
                  if f.endswith(".npy")}
        for camera in scene.cameras:
            fname = os.path.join(semantic_path,
                                 _cache_key(camera.name) + ".npy")
            if _cache_key(camera.name) in stored:
                camera.semantic_map = np.asarray(
                    np.load(fname, allow_pickle=True))
            else:
                seg = self.estimate(camera)
                camera.semantic_map = seg
                np.save(fname, seg)
                log.debug("segmented %s", camera.name)

    def estimate(self, camera) -> np.ndarray:
        if self.backend is None:
            self.backend = Mask2FormerBackend(self._model_id)
        if callable(self.backend) and not hasattr(self.backend, "predict"):
            return np.asarray(self.backend(camera))
        return self.backend.predict(camera)
