from .densify import densify_and_prune, prune_by_mask, reset_opacities
from .gaussians import (
    GaussianParams,
    GaussianState,
    compact_state,
    from_jax_params,
    from_state_dict,
    grow_capacity,
    init_from_pcd,
    state_dict,
)

__all__ = ["GaussianParams", "GaussianState", "compact_state", "densify_and_prune",
           "from_jax_params", "from_state_dict", "grow_capacity", "init_from_pcd",
           "prune_by_mask", "reset_opacities", "state_dict"]
