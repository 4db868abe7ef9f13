"""Black-Scholes paths and observation sampling (port of the BS part of
``njode_tpu.simulation.sde``).

Every generator produces a whole batch ``(B, n_steps+1)`` at once from one
explicit ``torch.Generator``; random numbers are drawn on the generator's
device and the results moved to ``device``.  PyTorch's generators give other
numbers than JAX's from the same seed, so the two packages agree in law,
not bit for bit.

* Black-Scholes: exact log-Euler via one cumsum (reference
  simulation/data_generation.py:30-44).
* Observation subsampling mirrors ``subsample_random_grid_points``
  (reference :221-252): ``n_obs = max(2, int(obs_fraction * n_grid))`` grid
  indices, endpoints always included, interior points uniform without
  replacement, so every trajectory keeps the same static number of
  observations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


def bs_paths(n_paths: int, mu: float = 0.0, sigma: float = 0.2,
             T: float = 1.0, n_steps: int = 100, x0: float = 1.0, *,
             generator: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32):
    """Black-Scholes log-Euler on the fixed grid.

    Returns (times (n+1,), X (B, n+1)).
    """
    dt = T / n_steps
    gen_device = generator.device
    times = torch.linspace(0.0, T, n_steps + 1, dtype=dtype, device=gen_device)
    dW = torch.randn(n_paths, n_steps, generator=generator, dtype=dtype,
                     device=gen_device) * math.sqrt(dt)
    log_inc = (mu - 0.5 * sigma ** 2) * dt + sigma * dW
    logX = torch.cat([torch.zeros(n_paths, 1, dtype=dtype, device=gen_device),
                      torch.cumsum(log_inc, dim=1)], dim=1) + math.log(x0)
    return times.to(device), torch.exp(logX).to(device)


def n_obs_for(obs_fraction: float, n_grid: int) -> int:
    """Static observation count (reference :236)."""
    return max(2, int(obs_fraction * n_grid))


def sample_obs_indices(n_paths: int, n_grid: int, obs_fraction: float = 0.1,
                       *, generator: torch.Generator,
                       device=None) -> torch.Tensor:
    """(B, n_obs) sorted int64 grid indices; 0 and n_grid-1 always included.

    Interior points are uniform without replacement (the law of
    ``np.random.choice(replace=False)``, reference :245): the top-k of iid
    uniform scores, for every count.
    """
    n_obs = n_obs_for(obs_fraction, n_grid)
    n_interior = min(n_obs - 2, n_grid - 2)
    gen_device = generator.device
    if n_interior > 0:
        scores = torch.rand(n_paths, n_grid - 2, generator=generator,
                            device=gen_device)
        top = torch.topk(scores, n_interior, dim=1).indices
        idx = torch.cat([
            torch.zeros(n_paths, 1, dtype=torch.long, device=gen_device),
            top + 1,  # shift into [1, n_grid-2]
            torch.full((n_paths, 1), n_grid - 1, dtype=torch.long,
                       device=gen_device)], dim=1)
    else:
        idx = torch.tensor([[0, n_grid - 1]],
                           device=gen_device).repeat(n_paths, 1)
    return torch.sort(idx, dim=1).values.to(device)


@dataclass
class TrajectoryBatch:
    """Dense observation batch.

    times:  (B, N) observation times (sorted, static N for a given config)
    values: (B, N, d_x) observations
    mask:   (B, N) bool (all True for same-config batches)
    grid_times: (G,) the dense simulation grid
    obs_idx:    (B, N) grid indices of the observations
    paths:      (B, G) full simulated paths
    switch_times: (B,) hybrid switch times or None
    """
    times: torch.Tensor
    values: torch.Tensor
    mask: torch.Tensor
    grid_times: torch.Tensor
    obs_idx: torch.Tensor
    paths: torch.Tensor
    switch_times: Optional[torch.Tensor] = None

    @property
    def n_trajectories(self) -> int:
        return self.times.shape[0]


def simulate_batch(n_trajectories: int, process_type: str = "black_scholes",
                   obs_fraction: float = 0.1, obs_only: bool = False, *,
                   generator: torch.Generator, device=None,
                   **process_kwargs) -> TrajectoryBatch:
    """Simulate B paths on the grid and subsample their observations.

    The paths are drawn first, then the observation indices, both from
    ``generator``.  Only Black-Scholes and the grid branch are ported.
    """
    if process_type != "black_scholes":
        raise NotImplementedError(
            f"process {process_type!r} is not ported yet (ROADMAP.md, "
            "Queue 1 item 10); only 'black_scholes' is")
    if obs_only:
        raise NotImplementedError(
            "obs_only sampling is not ported yet (ROADMAP.md, Queue 1 item 5)")
    grid_times, paths = bs_paths(n_trajectories, generator=generator,
                                 device=device, **process_kwargs)
    obs_idx = sample_obs_indices(n_trajectories, grid_times.shape[0],
                                 obs_fraction, generator=generator,
                                 device=device)
    times = grid_times[obs_idx]                                   # (B, N)
    values = torch.gather(paths, 1, obs_idx)[..., None]           # (B, N, 1)
    mask = torch.ones(times.shape, dtype=torch.bool, device=device)
    return TrajectoryBatch(times, values, mask, grid_times, obs_idx, paths)
