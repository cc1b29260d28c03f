"""Regularizers: the depth-guided term lives inline in the train step; the
SuGaR-style density / SDF term and the diffusion-guided views
(``diffusion_guidance``, imported by the trainer when it is asked for)
live here."""
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
