"""Regularizers: the depth-guided term lives inline in the train step; the
SuGaR-style density / SDF term lives here. The diffusion-guided views
(``regularizers/diffusion_guidance.py`` in the JAX package) are ROADMAP
Queue 1 item 17."""
from .density import (
    DensityProbe,
    approximate_density,
    covariance_inverse,
    density_at_points,
    density_loss,
    knn_indices,
    make_density_probe,
    probe_beta,
    sample_points,
)

__all__ = [
    "DensityProbe",
    "approximate_density",
    "covariance_inverse",
    "density_at_points",
    "density_loss",
    "knn_indices",
    "make_density_probe",
    "probe_beta",
    "sample_points",
]
