"""Batched SDE path simulators and observation sampling (port of
``njode_tpu.simulation.sde``).

Every generator produces a whole batch ``(B, n_steps+1)`` at once from one
explicit ``torch.Generator``; random numbers are drawn on the generator's
device and the results moved to ``device``.  PyTorch's generators give other
numbers than JAX's from the same seed, so the two packages agree in law,
not bit for bit.  Each generator first draws its normals (and uniforms)
from the generator, then applies a deterministic transform to them
(``_*_from_normals``); the CPU tests feed those transforms the JAX
package's own normals and hold the outputs to the JAX generators'.

* Black-Scholes: exact log-Euler via one cumsum (reference
  simulation/data_generation.py:30-44).
* OU: exact discretization ``X_{k+1} = a X_k + b + c xi_k`` (reference
  :80-92), a linear recurrence evaluated as an inclusive prefix over affine
  maps (:func:`affine_prefix`, log depth).
* Heston: Euler with correlated Brownians and the variance clamped at 1e-6
  before the square root and after the update (reference :190-216); the
  variance recurrence is a loop over the steps, the price a cumulative
  product given the variances.
* hybrid OU -> BS: both regimes affine in X, so one affine prefix with the
  regime chosen per step by ``step < switch_idx`` (reference :96-162).
* Observation subsampling mirrors ``subsample_random_grid_points``
  (reference :221-252): ``n_obs = max(2, int(obs_fraction * n_grid))`` grid
  indices, endpoints always included, interior points uniform without
  replacement, so every trajectory keeps the same static number of
  observations.
* ``obs_only=True`` samples the values exactly at the observation times
  (Black-Scholes, OU, hybrid and registered processes with an
  ``obs_values_fn``) and skips the unobserved grid: the same law, about
  n_grid / n_obs cheaper.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


# --------------------------------------------------------------------------
# the affine prefix
# --------------------------------------------------------------------------

def affine_prefix(A: torch.Tensor, U: torch.Tensor, dim: int):
    """Inclusive prefix of the affine maps ``x -> A_k x + U_k`` along
    ``dim``: (A_c, U_c) with ``X_k = A_c[k] x_0 + U_c[k]``.

    A log-depth doubling scan of elementwise ops (7 rounds for 100 steps),
    composing an earlier map (a1, u1) with a later one (a2, u2) as
    (a2 a1, a2 u1 + u2), the JAX package's ``_affine_combine``
    (``njode_tpu/simulation/sde.py:44``).  No cumulative product is
    divided, so a long decay (large theta T) cannot underflow into 0/0."""
    n = A.shape[dim]
    off = 1
    while off < n:
        a_prev, u_prev = A.narrow(dim, 0, n - off), U.narrow(dim, 0, n - off)
        a_cur, u_cur = A.narrow(dim, off, n - off), U.narrow(dim, off, n - off)
        A = torch.cat([A.narrow(dim, 0, off), a_cur * a_prev], dim)
        U = torch.cat([U.narrow(dim, 0, off), a_cur * u_prev + u_cur], dim)
        off *= 2
    return A, U


def _normals(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float,
             dtype) -> torch.Tensor:
    """Uniform(lo, hi) draws, ``lo + (hi - lo) u`` as JAX's ``uniform``."""
    u = torch.rand(n, generator=generator, dtype=dtype,
                   device=generator.device)
    return torch.clamp(lo + (hi - lo) * u, min=lo)


def _grid(T: float, n_steps: int, dtype, device) -> torch.Tensor:
    return torch.linspace(0.0, T, n_steps + 1, dtype=dtype, device=device)


def _ou_coeffs(theta: float, mu: float, sigma: float, dt: float):
    """(a, b, c) of the exact OU step; theta = 0 falls back to sigma
    sqrt(dt) (reference :84)."""
    a = math.exp(-theta * dt)
    b = mu * (1.0 - a)
    if theta > 0:
        c = sigma * math.sqrt((1.0 - math.exp(-2.0 * theta * dt))
                              / (2.0 * theta))
    else:
        c = sigma * math.sqrt(dt)
    return a, b, c


# --------------------------------------------------------------------------
# batched generators (B paths at once)
# --------------------------------------------------------------------------

def bs_paths(n_paths: int, mu: float = 0.0, sigma: float = 0.2,
             T: float = 1.0, n_steps: int = 100, x0: float = 1.0, *,
             generator: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32):
    """Black-Scholes log-Euler on the fixed grid.

    Returns (times (n+1,), X (B, n+1)).
    """
    dt = T / n_steps
    gen_device = generator.device
    times = _grid(T, n_steps, dtype, gen_device)
    dW = _normals(generator, (n_paths, n_steps), dtype) * math.sqrt(dt)
    log_inc = (mu - 0.5 * sigma ** 2) * dt + sigma * dW
    logX = torch.cat([torch.zeros(n_paths, 1, dtype=dtype, device=gen_device),
                      torch.cumsum(log_inc, dim=1)], dim=1) + math.log(x0)
    return times.to(device), torch.exp(logX).to(device)


def _ou_from_normals(z: torch.Tensor, theta: float = 1.0, mu: float = 0.0,
                     sigma: float = 0.3, T: float = 1.0, n_steps: int = 100,
                     x0: float = 0.0) -> torch.Tensor:
    """X (B, n+1) of :func:`ou_paths` from its normals z (B, n)."""
    a, b, c = _ou_coeffs(theta, mu, sigma, T / n_steps)
    u = b + c * z
    A_c, U_c = affine_prefix(torch.full_like(u, a), u, 1)
    return torch.cat([torch.full_like(u[:, :1], x0), A_c * x0 + U_c], dim=1)


def ou_paths(n_paths: int, theta: float = 1.0, mu: float = 0.0,
             sigma: float = 0.3, T: float = 1.0, n_steps: int = 100,
             x0: float = 0.0, *, generator: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32):
    """OU exact discretization ``X_{k+1} = a X_k + u_k`` with a =
    exp(-theta dt), u_k = mu (1 - a) + c xi_k, c = sigma sqrt((1 -
    exp(-2 theta dt)) / (2 theta)) (sigma sqrt(dt) at theta = 0).

    Returns (times (n+1,), X (B, n+1)).
    """
    z = _normals(generator, (n_paths, n_steps), dtype)
    X = _ou_from_normals(z, theta, mu, sigma, T, n_steps, x0)
    return _grid(T, n_steps, dtype, device or z.device), X.to(device)


def _heston_from_normals(z1: torch.Tensor, z2: torch.Tensor, mu: float = 0.0,
                         kappa: float = 2.0, theta: float = 0.04,
                         xi: float = 0.5, rho: float = -0.5, T: float = 1.0,
                         n_steps: int = 100, x0: float = 1.0,
                         v0: float = 0.04):
    """(X (B, n+1), V (B, n+1)) of :func:`heston_paths` from its normals
    z1, z2 (n, B).  Only the variance recurrence (square root and clamps)
    is sequential; given V, ``X_{n+1} = X_n (1 + mu dt + sqrt(V_n) dW1)``
    is a cumulative product."""
    dt = T / n_steps
    sdt = math.sqrt(dt)
    dW1 = sdt * z1
    dW2 = sdt * (rho * z1 + math.sqrt(1.0 - rho ** 2) * z2)
    V = torch.full_like(z1[0], v0)
    Vs = [V]
    for k in range(n_steps):
        sV = torch.sqrt(torch.clamp(V, min=1e-6))
        V = torch.clamp(V + kappa * (theta - V) * dt + xi * sV * dW2[k],
                        min=1e-6)
        Vs.append(V)
    V_all = torch.stack(Vs)                                   # (n+1, B)
    sV = torch.sqrt(torch.clamp(V_all[:-1], min=1e-6))        # V_n at step n
    factors = (1.0 + mu * dt) + sV * dW1                      # (n, B)
    X = torch.cat([torch.full_like(V_all[:1], x0),
                   x0 * torch.cumprod(factors, dim=0)], dim=0)
    return X.t(), V_all.t()


def heston_paths(n_paths: int, mu: float = 0.0, kappa: float = 2.0,
                 theta: float = 0.04, xi: float = 0.5, rho: float = -0.5,
                 T: float = 1.0, n_steps: int = 100, x0: float = 1.0,
                 v0: float = 0.04, *, generator: torch.Generator, device=None,
                 dtype: torch.dtype = torch.float32):
    """Heston Euler with correlated Brownians.

    Returns (times (n+1,), X (B, n+1), V (B, n+1)).
    """
    z1 = _normals(generator, (n_steps, n_paths), dtype)
    z2 = _normals(generator, (n_steps, n_paths), dtype)
    X, V = _heston_from_normals(z1, z2, mu, kappa, theta, xi, rho, T,
                                n_steps, x0, v0)
    return (_grid(T, n_steps, dtype, device or z1.device), X.to(device),
            V.to(device))


def _hybrid_from_normals(sw: torch.Tensor, z_ou: torch.Tensor,
                         z_bs: torch.Tensor, theta_ou: float = 1.0,
                         mu_ou: float = 0.0, sigma_ou: float = 0.3,
                         mu_bs: float = 0.0, sigma_bs: float = 0.2,
                         T: float = 1.0, n_steps: int = 100,
                         x0: float = 1.0) -> torch.Tensor:
    """X (B, n+1) of :func:`hybrid_ou_bs_paths` from the switch times sw
    (B,) and the normals z_ou, z_bs (n, B).  Every step is affine in X in
    both regimes (OU: X a + b + noise; BS: X exp(drift + noise)), so the
    path is one affine prefix with the regime chosen per step."""
    dt = T / n_steps
    switch_idx = (sw / dt).to(torch.int32)  # int() truncation, reference :140
    a, b, c = _ou_coeffs(theta_ou, mu_ou, sigma_ou, dt)
    ou_noise = c * z_ou
    bs_drift = (mu_bs - 0.5 * sigma_bs ** 2) * dt
    bs_noise = sigma_bs * math.sqrt(dt) * z_bs
    steps = torch.arange(n_steps, device=sw.device)
    is_ou = steps[:, None] < switch_idx[None, :]              # (n, B)
    A = torch.where(is_ou, a, torch.exp(bs_drift + bs_noise))
    U = torch.where(is_ou, b + ou_noise, 0.0)
    A_c, U_c = affine_prefix(A, U, 0)
    X = torch.cat([torch.full_like(A[:1], x0), A_c * x0 + U_c], dim=0)
    return X.t()


def hybrid_ou_bs_paths(n_paths: int, theta_ou: float = 1.0,
                       mu_ou: float = 0.0, sigma_ou: float = 0.3,
                       mu_bs: float = 0.0, sigma_bs: float = 0.2,
                       T: float = 1.0, n_steps: int = 100, x0: float = 1.0,
                       switch_time: Optional[float] = None, *,
                       generator: torch.Generator, device=None,
                       dtype: torch.dtype = torch.float32):
    """Hybrid OU -> BS paths, continuous at the (possibly random) switch.

    ``switch_time=None`` draws per-path switch times Uniform(0.2 T, 0.8 T)
    (reference :131-132).  Returns (times, X (B, n+1), switch_times (B,)).
    """
    if switch_time is None:
        sw = _uniform(generator, n_paths, 0.2 * T, 0.8 * T, dtype)
    else:
        sw = torch.full((n_paths,), switch_time, dtype=dtype,
                        device=generator.device)
    z_ou = _normals(generator, (n_steps, n_paths), dtype)
    z_bs = _normals(generator, (n_steps, n_paths), dtype)
    X = _hybrid_from_normals(sw, z_ou, z_bs, theta_ou, mu_ou, sigma_ou,
                             mu_bs, sigma_bs, T, n_steps, x0)
    return (_grid(T, n_steps, dtype, device or sw.device), X.to(device),
            sw.to(device))


# --------------------------------------------------------------------------
# single-path reference-API wrappers (generate_* names, reference :11-218)
# --------------------------------------------------------------------------

def _seeded(seed: Optional[int], generator: Optional[torch.Generator],
            device) -> torch.Generator:
    """``generator`` as given, else one seeded with ``seed`` (default 0) on
    ``device`` (the port's rule: None means cuda)."""
    if generator is not None:
        return generator
    from ..models.jump_ode import resolve_device
    return torch.Generator(device=resolve_device(device)).manual_seed(
        0 if seed is None else seed)


def generate_black_scholes(mu: float = 0.0, sigma: float = 0.2,
                           T: float = 1.0, n_steps: int = 100,
                           x0: float = 1.0, seed: Optional[int] = None,
                           generator: Optional[torch.Generator] = None,
                           device=None):
    gen = _seeded(seed, generator, device)
    times, X = bs_paths(1, mu, sigma, T, n_steps, x0, generator=gen)
    return times, X[0]


def generate_ou(theta: float = 1.0, mu: float = 0.0, sigma: float = 0.3,
                T: float = 1.0, n_steps: int = 100, x0: float = 0.0,
                seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None, device=None):
    gen = _seeded(seed, generator, device)
    times, X = ou_paths(1, theta, mu, sigma, T, n_steps, x0, generator=gen)
    return times, X[0]


def generate_heston(mu: float = 0.0, kappa: float = 2.0, theta: float = 0.04,
                    xi: float = 0.5, rho: float = -0.5, T: float = 1.0,
                    n_steps: int = 100, x0: float = 1.0, v0: float = 0.04,
                    seed: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    device=None):
    gen = _seeded(seed, generator, device)
    times, X, V = heston_paths(1, mu, kappa, theta, xi, rho, T, n_steps, x0,
                               v0, generator=gen)
    return times, X[0], V[0]


def generate_hybrid_ou_bs(theta_ou: float = 1.0, mu_ou: float = 0.0,
                          sigma_ou: float = 0.3, mu_bs: float = 0.0,
                          sigma_bs: float = 0.2, T: float = 1.0,
                          n_steps: int = 100, x0: float = 1.0,
                          switch_time: Optional[float] = None,
                          seed: Optional[int] = None,
                          generator: Optional[torch.Generator] = None,
                          device=None):
    gen = _seeded(seed, generator, device)
    times, X, sw = hybrid_ou_bs_paths(1, theta_ou, mu_ou, sigma_ou, mu_bs,
                                      sigma_bs, T, n_steps, x0, switch_time,
                                      generator=gen)
    return times, X[0], float(sw[0])


# --------------------------------------------------------------------------
# observation subsampling
# --------------------------------------------------------------------------

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
    else:   # made on the device: no copy from the host
        idx = torch.stack([
            torch.zeros(n_paths, dtype=torch.long, device=gen_device),
            torch.full((n_paths,), n_grid - 1, dtype=torch.long,
                       device=gen_device)], dim=1)
    return torch.sort(idx, dim=1).values.to(device)


def subsample_random_grid_points(times: torch.Tensor, values: torch.Tensor,
                                 obs_fraction: float = 0.1,
                                 seed: Optional[int] = None,
                                 generator: Optional[torch.Generator] = None):
    """Reference-API single-trajectory subsampler (reference :221-252); the
    generator is ``generator`` or one seeded with ``seed`` (default 0) on
    ``times``' device."""
    gen = _seeded(seed, generator, times.device)
    idx = sample_obs_indices(1, times.shape[0], obs_fraction, generator=gen,
                             device=times.device)[0]
    return times[idx], values[idx]


# --------------------------------------------------------------------------
# exact observation-time sampling (skip the unobserved grid)
# --------------------------------------------------------------------------
#
# Black-Scholes, OU and the hybrid OU->BS (both regimes affine, the switch at
# a known grid boundary) have exact transition laws over any gap, so the
# observed values can be sampled directly at the observation times, in the
# law of grid-simulate-then-subsample (the grid discretizations are exact;
# reference data_generation.py:30-44, :80-92, :96-162).

OBS_ONLY_PROCESSES = ("black_scholes", "ornstein_uhlenbeck", "hybrid_ou_bs")


def supports_obs_only(process_type: str) -> bool:
    """True when the process has an exact arbitrary-gap transition law.

    A registered process supports obs_only iff it declared an
    ``obs_values_fn`` (registry.py): a ``paths_fn`` registered under a
    built-in name disables the built-in sampler, because the registry's
    generator wins in :func:`simulate_batch` and the built-in transition
    law no longer describes the data."""
    from .registry import get_obs_values_fn, get_paths_fn
    if get_paths_fn(process_type) is not None:
        return get_obs_values_fn(process_type) is not None
    return process_type in OBS_ONLY_PROCESSES


def bs_values_at(times: torch.Tensor, mu: float = 0.0, sigma: float = 0.2,
                 x0: float = 1.0, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Exact BS samples at per-row sorted times (B, N) with times[:, 0] == 0:
    ``log X_j = log X_{j-1} + (mu - sigma^2/2) dt_j + sigma sqrt(dt_j) xi_j``
    (one lognormal increment per gap).  The normals are drawn on the
    generator's device; the result lies on ``times``' device."""
    times = times.to(dtype)
    dts = times[:, 1:] - times[:, :-1]                       # (B, N-1), > 0
    xi = _normals(generator, dts.shape, dtype).to(times.device)
    inc = (mu - 0.5 * sigma ** 2) * dts + sigma * torch.sqrt(dts) * xi
    log_x = torch.cat([torch.zeros_like(times[:, :1]),
                       torch.cumsum(inc, dim=1)], dim=1) + math.log(x0)
    return torch.exp(log_x)


def _ou_values_from_normals(times: torch.Tensor, xi: torch.Tensor,
                            theta: float = 1.0, mu: float = 0.0,
                            sigma: float = 0.3,
                            x0: float = 0.0) -> torch.Tensor:
    """Values (B, N) of :func:`ou_values_at` from its normals xi (B, N-1)."""
    dts = times[:, 1:] - times[:, :-1]                       # (B, N-1)
    if theta > 0:
        A = torch.exp(-theta * dts)
        c = sigma * torch.sqrt((1.0 - torch.exp(-2.0 * theta * dts))
                               / (2.0 * theta))
    else:
        A = torch.ones_like(dts)
        c = sigma * torch.sqrt(dts)
    u = mu * (1.0 - A) + c * xi
    A_c, U_c = affine_prefix(A, u, 1)
    return torch.cat([torch.full_like(times[:, :1], x0), A_c * x0 + U_c],
                     dim=1)


def ou_values_at(times: torch.Tensor, theta: float = 1.0, mu: float = 0.0,
                 sigma: float = 0.3, x0: float = 0.0, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Exact OU samples at per-row sorted times (B, N) with times[:, 0] ==
    0: the per-gap AR(1) ``X_j = a_j X_{j-1} + mu (1 - a_j) + c_j xi_j``,
    ``a_j = exp(-theta dt_j)``, ``c_j = sigma sqrt((1 - a_j^2) / (2
    theta))``, as one affine prefix over the gaps."""
    times = times.to(dtype)
    xi = _normals(generator, (times.shape[0], times.shape[1] - 1),
                  dtype).to(times.device)
    return _ou_values_from_normals(times, xi, theta, mu, sigma, x0)


def _hybrid_values_from_normals(times: torch.Tensor, sw: torch.Tensor,
                                xi_ou: torch.Tensor, xi_bs: torch.Tensor,
                                theta_ou: float = 1.0, mu_ou: float = 0.0,
                                sigma_ou: float = 0.3, mu_bs: float = 0.0,
                                sigma_bs: float = 0.2, x0: float = 1.0,
                                T: float = 1.0,
                                n_steps: int = 100) -> torch.Tensor:
    """Values (B, N) of :func:`hybrid_values_at` from the drawn switch
    times sw (B,) and the normals xi_ou, xi_bs (B, N-1)."""
    dt = T / n_steps
    t_eff = torch.floor(sw / dt) * dt          # the grid's regime boundary
    t0, t1 = times[:, :-1], times[:, 1:]       # (B, N-1) gap endpoints
    swc = t_eff[:, None]
    d1 = torch.clamp(torch.minimum(t1, swc) - torch.minimum(t0, swc),
                     min=0.0)                                  # OU part
    d2 = torch.clamp(t1 - torch.maximum(t0, swc), min=0.0)     # BS part
    if theta_ou > 0:
        a = torch.exp(-theta_ou * d1)
        c = sigma_ou * torch.sqrt((1.0 - torch.exp(-2.0 * theta_ou * d1))
                                  / (2.0 * theta_ou))
    else:
        a = torch.ones_like(d1)
        c = sigma_ou * torch.sqrt(d1)
    u = mu_ou * (1.0 - a) + c * xi_ou
    G = torch.exp((mu_bs - 0.5 * sigma_bs ** 2) * d2
                  + sigma_bs * torch.sqrt(d2) * xi_bs)
    # the gap map X -> G (a X + u) = (G a) X + (G u)
    A_c, U_c = affine_prefix(G * a, G * u, 1)
    return torch.cat([torch.full_like(times[:, :1], x0), A_c * x0 + U_c],
                     dim=1)


def hybrid_values_at(times: torch.Tensor, theta_ou: float = 1.0,
                     mu_ou: float = 0.0, sigma_ou: float = 0.3,
                     mu_bs: float = 0.0, sigma_bs: float = 0.2,
                     x0: float = 1.0, switch_time: Optional[float] = None,
                     T: float = 1.0, n_steps: int = 100, *,
                     generator: torch.Generator,
                     dtype: torch.dtype = torch.float32):
    """Exact hybrid OU -> BS samples at per-row sorted grid times (B, N).

    Both regimes are affine in X over any gap, so the gap map through the
    switch is the composition BS o OU, itself affine: one affine prefix over
    the observation gaps.  The per-path switch time is drawn first, as in
    the grid generator (reference data_generation.py:131-132), and the gaps
    split at the grid's effective switch ``floor(sw/dt) dt``, where the grid
    path changes regime (the ``int()`` truncation at reference :140).

    Returns ``(values (B, N), switch_times (B,))``, the switch times as
    drawn, as :func:`hybrid_ou_bs_paths` returns them.
    """
    times = times.to(dtype)
    B, N = times.shape
    if switch_time is None:
        sw = _uniform(generator, B, 0.2 * T, 0.8 * T, dtype)
    else:
        sw = torch.full((B,), switch_time, dtype=dtype,
                        device=generator.device)
    xi_ou = _normals(generator, (B, N - 1), dtype)
    xi_bs = _normals(generator, (B, N - 1), dtype)
    sw, xi_ou, xi_bs = (x.to(times.device) for x in (sw, xi_ou, xi_bs))
    X = _hybrid_values_from_normals(times, sw, xi_ou, xi_bs, theta_ou, mu_ou,
                                    sigma_ou, mu_bs, sigma_bs, x0, T,
                                    n_steps)
    return X, sw


# --------------------------------------------------------------------------
# batched trajectory construction
# --------------------------------------------------------------------------

@dataclass
class TrajectoryBatch:
    """Dense observation batch.

    times:  (B, N) observation times (sorted, static N for a given config)
    values: (B, N, d_x) observations
    mask:   (B, N) bool (all True for same-config batches)
    grid_times: (G,) the dense simulation grid
    obs_idx:    (B, N) grid indices of the observations
    paths:      (B, G) full simulated paths, (B, G, d) for multi-dim
                processes (None when obs_only)
    switch_times: (B,) hybrid switch times or None
    """
    times: torch.Tensor
    values: torch.Tensor
    mask: torch.Tensor
    grid_times: torch.Tensor
    obs_idx: torch.Tensor
    paths: Optional[torch.Tensor]
    switch_times: Optional[torch.Tensor] = None

    @property
    def n_trajectories(self) -> int:
        return self.times.shape[0]


PROCESS_TYPES = ("black_scholes", "ornstein_uhlenbeck", "heston",
                 "hybrid_ou_bs")


def simulate_batch(n_trajectories: int, process_type: str = "black_scholes",
                   obs_fraction: float = 0.1, obs_only: bool = False, *,
                   generator: torch.Generator, device=None,
                   **process_kwargs) -> TrajectoryBatch:
    """Simulate B paths and subsample their observations
    (``njode_tpu/simulation/sde.py:463-558``).

    Grid branch: the paths are drawn first, then the observation indices,
    both from ``generator``; a registered process's ``paths_fn`` wins over
    a built-in family of its name.  Heston's V is dropped and hybrid's
    switch times kept.  ``obs_only=True`` (:func:`supports_obs_only`): the
    indices first, then the values exactly at the observation times;
    ``paths`` is None, and times are ``obs_idx * (T / n_steps)`` as f32
    arithmetic, as in the JAX package (``sde.py:505``).
    """
    from .registry import get_obs_values_fn, get_paths_fn
    if obs_only:
        if not supports_obs_only(process_type):
            raise ValueError(
                f"obs_only sampling needs an exact transition law; "
                f"'{process_type}' is not in {OBS_ONLY_PROCESSES} (or is "
                f"overridden by a registered custom generator)")
        T = float(process_kwargs.get("T", 1.0))
        n_steps = int(process_kwargs.get("n_steps", 100))
        kw = {k: v for k, v in process_kwargs.items()
              if k not in ("T", "n_steps")}
        grid_times = torch.linspace(0.0, T, n_steps + 1, device=device)
        obs_idx = sample_obs_indices(n_trajectories, n_steps + 1,
                                     obs_fraction, generator=generator,
                                     device=device)
        # T / n_steps rounded as f32 division, as a host scalar: no copy to
        # the device, so a CUDA graph can hold the draw
        spacing = float(np.float32(T) / np.float32(n_steps))
        times = obs_idx.to(torch.float32) * spacing
        switch_times = None
        custom_obs = get_obs_values_fn(process_type)
        if custom_obs is not None:
            values = custom_obs(times, generator=generator, **kw)
        elif process_type == "black_scholes":
            values = bs_values_at(times, generator=generator, **kw)
        elif process_type == "ornstein_uhlenbeck":
            values = ou_values_at(times, generator=generator, **kw)
        else:  # hybrid_ou_bs: the regime split needs the grid's spacing
            values, switch_times = hybrid_values_at(
                times, T=T, n_steps=n_steps, generator=generator, **kw)
        if values.dim() == 2:
            values = values[..., None]
        mask = torch.ones(times.shape, dtype=torch.bool, device=times.device)
        return TrajectoryBatch(times, values, mask, grid_times, obs_idx, None,
                               switch_times)
    switch_times = None
    gk = dict(generator=generator, device=device)
    custom = get_paths_fn(process_type)
    if custom is not None:
        out = custom(n_trajectories, **gk, **process_kwargs)
        if len(out) == 3:
            grid_times, paths, switch_times = out
        else:
            grid_times, paths = out
    elif process_type == "black_scholes":
        grid_times, paths = bs_paths(n_trajectories, **gk, **process_kwargs)
    elif process_type == "ornstein_uhlenbeck":
        grid_times, paths = ou_paths(n_trajectories, **gk, **process_kwargs)
    elif process_type == "heston":
        grid_times, paths, _V = heston_paths(n_trajectories, **gk,
                                             **process_kwargs)
    elif process_type == "hybrid_ou_bs":
        grid_times, paths, switch_times = hybrid_ou_bs_paths(
            n_trajectories, **gk, **process_kwargs)
    else:
        raise ValueError(f"Unknown process type: {process_type}. Supported: "
                         f"{', '.join(PROCESS_TYPES)}")
    obs_idx = sample_obs_indices(n_trajectories, grid_times.shape[0],
                                 obs_fraction, generator=generator,
                                 device=paths.device)
    times = grid_times.to(paths.device)[obs_idx]                 # (B, N)
    if paths.dim() == 3:   # multi-dimensional process: paths (B, G, d)
        values = torch.gather(
            paths, 1, obs_idx[..., None].expand(-1, -1, paths.shape[-1]))
    else:
        values = torch.gather(paths, 1, obs_idx)[..., None]      # (B, N, 1)
    mask = torch.ones(times.shape, dtype=torch.bool, device=times.device)
    return TrajectoryBatch(times, values, mask, grid_times, obs_idx, paths,
                           switch_times)


def create_trajectory_batch(n_trajectories: int,
                            process_type: str = "black_scholes",
                            obs_fraction: float = 0.1,
                            seed: Optional[int] = None, *, device=None,
                            **process_kwargs):
    """Reference-API batch factory returning ragged lists (reference
    :255-291): (batch_times, a list of (n_i,), batch_values, a list of
    (n_i, d_x)).  All rows share n_i by construction, as in the reference.
    Deterministic in ``seed`` (default 0); the generator lies on ``device``
    (None means cuda)."""
    batch = simulate_batch(n_trajectories, process_type, obs_fraction,
                           generator=_seeded(seed, None, device),
                           **process_kwargs)
    return ([batch.times[b] for b in range(n_trajectories)],
            [batch.values[b] for b in range(n_trajectories)])
