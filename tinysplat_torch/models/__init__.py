from .densify import densify_and_prune, prune_by_mask, reset_opacities
from .densify_mcmc import apply_noise, inject_noise, relocate_and_grow, relocation_adjustment
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

__all__ = ["GaussianParams", "GaussianState", "apply_noise", "compact_state",
           "densify_and_prune", "from_jax_params", "from_state_dict", "grow_capacity",
           "init_from_pcd", "inject_noise", "prune_by_mask", "relocate_and_grow",
           "relocation_adjustment", "reset_opacities", "state_dict"]
