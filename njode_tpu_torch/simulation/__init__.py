"""Data layer: Black-Scholes paths, observation sampling and the closed-form
conditional moments."""

from .moments import moments_at_obs
from .sde import (OBS_ONLY_PROCESSES, TrajectoryBatch, bs_paths, bs_values_at,
                  n_obs_for, sample_obs_indices, simulate_batch,
                  supports_obs_only)

__all__ = ["OBS_ONLY_PROCESSES", "TrajectoryBatch", "bs_paths",
           "bs_values_at", "moments_at_obs", "n_obs_for",
           "sample_obs_indices", "simulate_batch", "supports_obs_only"]
