from .gaussians import (
    GaussianParams,
    GaussianState,
    from_jax_params,
    from_state_dict,
    init_from_pcd,
    state_dict,
)

__all__ = ["GaussianParams", "GaussianState", "from_jax_params",
           "from_state_dict", "init_from_pcd", "state_dict"]
