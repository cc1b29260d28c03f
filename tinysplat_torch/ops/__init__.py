from .projection import project_gaussians, ProjectedGaussians
from .sh import eval_sh, num_sh_bases, deg_from_sh
from .rasterize_dense import rasterize_dense

__all__ = [
    "project_gaussians",
    "ProjectedGaussians",
    "eval_sh",
    "num_sh_bases",
    "deg_from_sh",
    "rasterize_dense",
]
