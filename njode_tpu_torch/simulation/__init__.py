"""Data layer: the SDE families (Black-Scholes, OU, Heston, hybrid OU->BS,
and the d-dimensional BS and OU), observation sampling, the process
registry and the closed-form conditional moments."""

from .sde import (
    PROCESS_TYPES,
    TrajectoryBatch,
    bs_paths,
    bs_values_at,
    create_trajectory_batch,
    generate_black_scholes,
    generate_heston,
    generate_hybrid_ou_bs,
    generate_ou,
    heston_paths,
    hybrid_ou_bs_paths,
    hybrid_values_at,
    n_obs_for,
    ou_paths,
    ou_values_at,
    sample_obs_indices,
    simulate_batch,
    subsample_random_grid_points,
    supports_obs_only,
)
from .registry import (
    get_moments_fn,
    get_obs_values_fn,
    get_paths_fn,
    register_process,
    registered_processes,
)
from .multidim import (
    bs_nd_moments,
    bs_nd_values_at,
    bs_paths_nd,
    ou_nd_moments,
    ou_nd_values_at,
    ou_paths_nd,
)
from .moments import (
    condexp_black_scholes_on_grid,
    condexp_heston_on_grid,
    condexp_hybrid_on_grid,
    condexp_ou_on_grid,
    condvar_black_scholes_on_grid,
    condvar_heston_on_grid,
    condvar_ou_on_grid,
    get_conditional_moments_at_obs,
    moments_at_obs,
)

__all__ = [
    "PROCESS_TYPES", "TrajectoryBatch", "bs_paths", "create_trajectory_batch",
    "generate_black_scholes", "generate_heston", "generate_hybrid_ou_bs",
    "generate_ou", "heston_paths", "hybrid_ou_bs_paths", "n_obs_for",
    "ou_paths", "sample_obs_indices", "simulate_batch",
    "bs_values_at", "ou_values_at", "hybrid_values_at", "supports_obs_only",
    "subsample_random_grid_points",
    "condexp_black_scholes_on_grid", "condexp_heston_on_grid",
    "condexp_hybrid_on_grid", "condexp_ou_on_grid",
    "condvar_black_scholes_on_grid", "condvar_heston_on_grid",
    "condvar_ou_on_grid", "get_conditional_moments_at_obs", "moments_at_obs",
    "register_process", "registered_processes", "get_paths_fn",
    "get_obs_values_fn", "get_moments_fn",
    "bs_paths_nd", "ou_paths_nd", "bs_nd_moments", "ou_nd_moments",
    "bs_nd_values_at", "ou_nd_values_at",
]
