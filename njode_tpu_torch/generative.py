"""Generative sampling from a trained NJ-ODE (port of ``njode_tpu.generative``).

The model learns the conditional mean (and variance) of the process at any
horizon given the last observation; that law supports a moment-matched
autoregressive sampler (cf. "Neural Jump ODEs as Generative Models",
arXiv:2510.02757 — PAPERS.md): from ``x0``, repeatedly

  1. jump-encode the current sample      h   = jump_nn(x_i)
  2. integrate the latent over the gap   h⁻  = odeint(h, t_i -> t_{i+1})
  3. read out conditional moments        (m, v) = output_nn(h⁻)
  4. draw the next sample                x_{i+1} ~ law(m, v)

All paths advance together, one grid step at a time.  Step 2 is the model's
inference gap (``_integrate_gap(..., inference=True)``), so with
``dt_ode_step`` set and an ODEFunc the gap kernel computes, each grid step
is one launch of that kernel on the card (its plain version on the CPU).

Step laws:

* ``"gaussian"``:  x' ~ N(m, v).
* ``"lognormal"``: lognormal with mean m and variance v (the gaussian draw
  where m <= 0).
* ``"mean"``:      the deterministic conditional-mean rollout (the only law
  of a one-moment model).

Random streams: :func:`sample_paths` draws every normal first, ``(G, B,
d_y)`` on the model's device from the caller's ``torch.Generator``; the
deterministic core :func:`sample_paths_from_normals` does the rollout with
``normals[i]`` in the place of the JAX package's
``jax.random.normal(split(key, G)[i], (B, d_y))``, so the core takes that
package's own normals in the tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from .models.jump_ode import NeuralJumpODE

STEP_LAWS = ("gaussian", "lognormal", "mean")


def _check_law(model: NeuralJumpODE, law: str) -> None:
    if law not in STEP_LAWS:
        raise ValueError(f"Unknown step law: {law}; one of {STEP_LAWS}")
    if law != "mean" and model.num_moments < 2:
        raise ValueError(
            f"law='{law}' needs a 2-moment model (num_moments="
            f"{model.num_moments}); use law='mean'")


def _draw(law: str, mean: torch.Tensor, var: torch.Tensor,
          z: Optional[torch.Tensor]) -> torch.Tensor:
    """One draw of the step law from the standard normals ``z``
    (``njode_tpu/generative.py:54``)."""
    if law == "mean":
        return mean
    std = torch.sqrt(torch.clamp_min(var, 0.0))
    if law == "gaussian":
        return mean + std * z
    # lognormal with matched mean/variance:
    #   sigma^2 = log(1 + v/m^2), mu = log m - sigma^2/2  (m > 0)
    m_safe = torch.clamp_min(mean, 1e-12)
    s2 = torch.log1p(var / (m_safe * m_safe))
    mu = torch.log(m_safe) - 0.5 * s2
    x = torch.exp(mu + torch.sqrt(s2) * z)
    # the gaussian draw where the mean is non-positive
    return torch.where(mean > 0, x, mean + std * z)


def _time_grid(model: NeuralJumpODE, grid_times, n_paths: int
               ) -> torch.Tensor:
    """(B, G) target times from (G,) shared or (B, G) per-path times."""
    grid_times = model._as_tensor(grid_times)
    if grid_times.ndim == 2:
        if grid_times.shape[0] != n_paths:
            raise ValueError(f"per-path times have leading dim "
                             f"{grid_times.shape[0]}, expected "
                             f"n_paths={n_paths}")
        return grid_times
    return grid_times[None].expand(n_paths, grid_times.shape[0])


def sample_paths(model: NeuralJumpODE, generator: torch.Generator,
                 n_paths: int, grid_times, x0, law: str = "gaussian",
                 obs_times=None, obs_values=None) -> torch.Tensor:
    """Sample ``n_paths`` trajectories from the model's learned dynamics.

    Args:
      model: a (trained) NJ-ODE; the stochastic laws need num_moments >= 2.
      generator: the ``torch.Generator`` the normals are drawn from, on the
        model's device.
      n_paths: number of sampled trajectories B.
      grid_times: strictly increasing target times, (G,) shared by every
        path or (B, G) per path; any spacing (each step integrates its own
        gap, as ``predict_at`` does).
      x0: the value(s) at ``grid_times[0]``: a scalar, (d_x,), (B,) with
        d_x 1, or (B, d_x).  Ignored when a conditioning prefix is given.
      law: "gaussian" | "lognormal" | "mean" (module docstring).
      obs_times/obs_values: an optional conditioning prefix, (N,) sorted
        times (all <= grid_times[0]) and (N, d_x) values shared by every
        sample; the rollout then starts from the last observation and
        integrates to ``grid_times[0]`` before the first draw.

    Returns: samples (B, G, d_x); ``samples[:, 0]`` is x0 without a prefix
    and the first draw with one.
    """
    _check_law(model, law)
    normals = None
    if law != "mean":
        G = model._as_tensor(grid_times).shape[-1]
        normals = torch.randn(G, n_paths, model.output_dim,
                              generator=generator, dtype=model.dtype,
                              device=model.device)
    return sample_paths_from_normals(model, normals, n_paths, grid_times, x0,
                                     law, obs_times, obs_values)


def sample_paths_from_normals(model: NeuralJumpODE,
                              normals: Optional[torch.Tensor], n_paths: int,
                              grid_times, x0, law: str = "gaussian",
                              obs_times=None, obs_values=None
                              ) -> torch.Tensor:
    """The deterministic rollout of :func:`sample_paths`
    (``njode_tpu/generative.py:72-166``): ``normals`` (G, B, d_y) are the
    standard normals of each grid step's draw (step 0's is read only with
    a conditioning prefix); None is allowed for ``law="mean"``."""
    _check_law(model, law)
    B, d_x = n_paths, model.input_dim
    with model._inference():
        t_grid = _time_grid(model, grid_times, B)             # (B, G)
        G = t_grid.shape[1]
        if normals is not None:
            normals = model._as_tensor(normals)
        if obs_values is not None:
            obs_times = model._as_tensor(obs_times)
            obs_values = model._as_tensor(obs_values).reshape(-1, d_x)
            x_start = obs_values[-1].expand(B, d_x)
            t_start = obs_times[-1].expand(B)
            first_is_draw = True
        else:
            x0a = model._as_tensor(x0)
            x0a = (x0a.expand(1, d_x) if x0a.ndim == 0
                   else x0a.reshape(-1, d_x))
            x_start = x0a.expand(B, d_x)
            t_start = t_grid[:, 0]
            first_is_draw = False

        model._check_gap_budget(torch.diff(
            torch.cat([t_start[:, None], t_grid], dim=1), dim=1))

        def one_step(x_cur, t_cur, t_next, i):
            """Every path one grid cell on: jump, integrate, read out,
            draw."""
            h = model._jump(x_cur)                            # (K_h, B, d_h)
            h = model._integrate_gap(h, x_cur, t_cur, t_next,
                                     inference=True)
            raw = model._readout(h)                           # (B, d_y, K)
            mean = raw[..., 0]
            var = (model.variance_from_raw(raw) if model.num_moments > 1
                   else torch.zeros_like(mean))
            return _draw(law, mean, var,
                         None if normals is None else normals[i])

        x = (one_step(x_start, t_start, t_grid[:, 0], 0) if first_is_draw
             else x_start)
        xs = [x]
        for i in range(1, G):
            x = one_step(x, t_grid[:, i - 1], t_grid[:, i], i)
            xs.append(x)
        return torch.stack(xs, dim=1)                         # (B, G, d_x)
