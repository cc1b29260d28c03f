"""Model loading from the JAX package's ``.npz`` checkpoints.

``tinysplat_tpu.io.checkpoint.save_checkpoint`` writes the compact live-splat
model under ``model/<field>`` keys beside the full training state. Serving
needs only the model, so a JAX checkpoint serves from the port unchanged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.gaussians import GaussianState, from_state_dict


def load_model(path: str, capacity: Optional[int] = None, device="cuda") -> GaussianState:
    """Model-only load: the ``model/*`` keys of a checkpoint, padded to
    ``capacity`` (default: next power of two >= 2N) on ``device``."""
    with np.load(path) as z:
        sd = {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("model/")}
    if "means" not in sd:
        raise ValueError(f"{path} holds no model/* arrays")
    return from_state_dict(sd, capacity=capacity, device=device)
