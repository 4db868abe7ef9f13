"""Closed-form conditional moments at the observations (port of the
Black-Scholes branch of ``njode_tpu.simulation.moments``).

Conventions of the reference's at-observation evaluators
(reference simulation/data_generation.py:543-816):

* after-jump truth = the observed value, variance 0;
* before-jump truth = the closed-form propagation from the previous
  observation;
* the first observation's before-value = the observation itself, variance 0.

Other process families raise ``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor


def _ipow(x, p: int):
    """x ** p for an integer p >= 0 by binary exponentiation, the order of
    products ``lax.integer_pow`` takes, so f32 results round alike."""
    if p == 0:
        return torch.ones_like(x) if isinstance(x, Tensor) else 1.0
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p > 0:
            x = x * x
    return acc


def _bs_mean(prev: Tensor, dt: Tensor, mu: float) -> Tensor:
    return prev * torch.exp(mu * dt)


def _bs_var(prev: Tensor, dt: Tensor, mu: float, sigma: float) -> Tensor:
    return _ipow(prev, 2) * (torch.exp(sigma ** 2 * dt) - 1.0) * torch.exp(2.0 * mu * dt)


def _bs_raw_moment(prev: Tensor, dt: Tensor, mu: float, sigma: float,
                   p: int) -> Tensor:
    """Lognormal: E[X_t^p | X_s] = X_s^p exp(p mu dt + p(p-1)/2 sigma^2 dt)."""
    return _ipow(prev, p) * torch.exp(p * mu * dt + 0.5 * p * (p - 1)
                                      * sigma ** 2 * dt)


def _bs_central_moment(prev: Tensor, dt: Tensor, mu: float, sigma: float,
                       p: int) -> Tensor:
    """E[(X - E[X])^p | X_s] by the binomial expansion over raw moments."""
    m1 = _bs_raw_moment(prev, dt, mu, sigma, 1)
    out = torch.zeros_like(prev)
    for j in range(p + 1):
        r_j = _bs_raw_moment(prev, dt, mu, sigma, j) if j > 0 else 1.0
        out = out + math.comb(p, j) * r_j * _ipow(-m1, p - j)
    return out


def moments_at_obs(times: Tensor, values: Tensor, process_type: str,
                   num_moments: int = 1, variance_method: str = "direct",
                   mask: Optional[Tensor] = None,
                   switch_times: Optional[Tensor] = None,
                   **process_params) -> tuple[Tensor, Tensor]:
    """Analytic conditional moments shaped like the model's outputs.

    Args:
      times:  (B, N) observation times.
      values: (B, N, d_x) observations.
      process_params: ``mu`` and ``sigma`` (defaults 0.0 and 0.2, the
        reference's); other keys are ignored.

    Returns: (moments, moments_before), each (B, N, d_x, num_moments).
    Moments >= 2 (the extension) are central moments for ``direct`` and raw
    moments for ``second_moment``, up to the 4th.
    """
    if process_type != "black_scholes":
        raise NotImplementedError(
            f"moments_at_obs: {process_type!r} is not ported yet "
            "(ROADMAP.md, Queue 1 item 9); only 'black_scholes' is")
    if variance_method not in ("direct", "second_moment"):
        raise ValueError(f"Unknown variance_method: {variance_method}")
    mu = float(process_params.get("mu", 0.0))
    sigma = float(process_params.get("sigma", 0.2))
    B, N, _ = values.shape
    dt = torch.cat([torch.zeros_like(times[:, :1]),
                    times[:, 1:] - times[:, :-1]], dim=1)[..., None]
    prev = torch.cat([values[:, :1], values[:, :-1]], dim=1)
    first = torch.zeros((B, N, 1), dtype=torch.bool, device=values.device)
    first[:, 0] = True

    mean_after = values
    mean_before = torch.where(first, values, _bs_mean(prev, dt, mu))
    var_after = torch.zeros_like(values)
    var_before = torch.where(first, 0.0, _bs_var(prev, dt, mu, sigma))
    moments, moments_before = [mean_after], [mean_before]
    if num_moments > 1:
        if variance_method == "direct":
            moments.append(var_after)
            moments_before.append(var_before)
        else:                        # E[X^2] = Var + E[X]^2 (reference :910-913)
            moments.append(var_after + _ipow(mean_after, 2))
            moments_before.append(var_before + _ipow(mean_before, 2))
    raw = variance_method == "second_moment"
    for m_idx in range(len(moments), num_moments):
        p = m_idx + 1
        if p > 4:
            moments.append(torch.zeros_like(values))
            moments_before.append(torch.zeros_like(values))
            continue
        if raw:
            after = _ipow(values, p)
            before = torch.where(first, after,
                                 _bs_raw_moment(prev, dt, mu, sigma, p))
        else:
            after = torch.zeros_like(values)
            before = torch.where(first, 0.0,
                                 _bs_central_moment(prev, dt, mu, sigma, p))
        moments.append(after)
        moments_before.append(before)

    out = torch.stack(moments, dim=-1)
    out_b = torch.stack(moments_before, dim=-1)
    if mask is not None:
        m = mask.to(torch.bool)[..., None, None]
        out = torch.where(m, out, 0.0)
        out_b = torch.where(m, out_b, 0.0)
    return out, out_b
