"""Data layer: Black-Scholes paths and observation sampling."""

from .sde import (TrajectoryBatch, bs_paths, n_obs_for, sample_obs_indices,
                  simulate_batch)

__all__ = ["TrajectoryBatch", "bs_paths", "n_obs_for", "sample_obs_indices",
           "simulate_batch"]
