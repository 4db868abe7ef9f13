"""Closed-form conditional moments (port of ``njode_tpu.simulation.moments``).

Conventions of the reference's at-observation evaluators
(reference simulation/data_generation.py:543-816):

* after-jump truth = the observed value, variance 0;
* before-jump truth = the closed-form propagation from the previous
  observation;
* the first observation's before-value = the observation itself, variance 0;
* hybrid: the regimes are split into subsequences, so the first observation
  in the BS regime also gets before-value = itself (:744-761).

Heston takes the BS formulas with xi in sigma's place, for the mean and
variance only (the paper-appendix approximation, reference :619-630).
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


# --------------------------------------------------------------------------
# before-jump propagators E[X_t | X_s], Var[X_t | X_s] with s = t - dt
# --------------------------------------------------------------------------

def _bs_mean(prev: Tensor, dt: Tensor, mu) -> Tensor:
    return prev * torch.exp(mu * dt)


def _bs_var(prev: Tensor, dt: Tensor, mu, sigma) -> Tensor:
    return (_ipow(prev, 2) * (torch.exp(_ipow(sigma, 2) * dt) - 1.0)
            * torch.exp(2.0 * mu * dt))


def _ou_mean(prev: Tensor, dt: Tensor, theta, mu) -> Tensor:
    decay = torch.exp(-theta * dt)
    return prev * decay + mu * (1.0 - decay)


def _ou_var(dt: Tensor, theta, sigma) -> Tensor:
    return (_ipow(sigma, 2) / (2.0 * theta)
            * (1.0 - torch.exp(-2.0 * theta * dt)))


# higher conditional moments (an extension: the reference zero-fills
# moments >= 2)

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


def _ou_raw_moment(prev: Tensor, dt: Tensor, theta: float, mu: float,
                   sigma: float, p: int) -> Tensor:
    """The Gaussian conditional law N(m, v): raw moments up to p = 4."""
    m = _ou_mean(prev, dt, theta, mu)
    v = _ou_var(dt, theta, sigma)
    if p == 1:
        return m
    if p == 2:
        return _ipow(m, 2) + v
    if p == 3:
        return _ipow(m, 3) + 3.0 * m * v
    if p == 4:
        return (_ipow(m, 4) + 6.0 * _ipow(m, 2) * v + 3.0 * _ipow(v, 2))
    raise ValueError(f"OU raw moment p={p} unsupported (max 4)")


def _ou_central_moment(prev: Tensor, dt: Tensor, theta: float, sigma: float,
                       p: int) -> Tensor:
    v = _ou_var(dt, theta, sigma)
    if p == 2:
        return torch.broadcast_to(v, prev.shape)
    if p == 3:
        return torch.zeros_like(prev)
    if p == 4:
        return torch.broadcast_to(3.0 * _ipow(v, 2), prev.shape)
    raise ValueError(f"OU central moment p={p} unsupported (max 4)")


def _masked(out: Tensor, out_b: Tensor, mask: Optional[Tensor]):
    if mask is None:
        return out, out_b
    m = mask.to(torch.bool)[..., None, None]
    return torch.where(m, out, 0.0), torch.where(m, out_b, 0.0)


# --------------------------------------------------------------------------
# at-observation truths (dense, batched)
# --------------------------------------------------------------------------

def moments_at_obs(times: Tensor, values: Tensor, process_type: str,
                   num_moments: int = 1, variance_method: str = "direct",
                   mask: Optional[Tensor] = None,
                   switch_times: Optional[Tensor] = None,
                   **process_params) -> tuple[Tensor, Tensor]:
    """Analytic conditional moments shaped like the model's outputs
    (``njode_tpu/simulation/moments.py:104-292``).

    Args:
      times:  (B, N) observation times.
      values: (B, N, d_x) observations.
      switch_times: hybrid per-trajectory switch times (B,); they take the
        place of a scalar ``switch_time`` in ``process_params``.
      process_params: the keys and defaults of the reference's
        ``get_conditional_moments_at_obs`` (data_generation.py:819-922);
        other keys are ignored.

    Returns: (moments, moments_before), each (B, N, d_x, num_moments).
    Moments >= 2 (the extension) are central moments for ``direct`` and raw
    moments for ``second_moment``, up to the 4th, for BS, OU and hybrid;
    Heston refuses them.  A registered ``moments_fn`` wins over a built-in
    family of its name.
    """
    from .registry import get_moments_fn
    custom = get_moments_fn(process_type)
    if custom is not None:
        if switch_times is not None:
            process_params = dict(process_params, switch_times=switch_times)
        out, out_b = custom(times, values, num_moments=num_moments,
                            variance_method=variance_method, **process_params)
        return _masked(out, out_b, mask)

    B, N, _ = values.shape
    dtype = values.dtype
    dt = torch.cat([torch.zeros_like(times[:, :1]),
                    times[:, 1:] - times[:, :-1]], dim=1)[..., None]
    prev = torch.cat([values[:, :1], values[:, :-1]], dim=1)
    first = torch.zeros((B, N, 1), dtype=torch.bool, device=values.device)
    first[:, 0] = True

    p = process_params
    hybrid_regime = None  # (in_ou, regime_first) where hybrid truths exist
    disabled = False
    if process_type == "black_scholes":
        mean_b = _bs_mean(prev, dt, p.get("mu", 0.0))
        var_b = _bs_var(prev, dt, p.get("mu", 0.0), p.get("sigma", 0.2))
    elif process_type == "ornstein_uhlenbeck":
        mean_b = _ou_mean(prev, dt, p.get("theta", 1.0), p.get("mu", 0.0))
        var_b = torch.broadcast_to(
            _ou_var(dt, p.get("theta", 1.0), p.get("sigma", 0.3)), prev.shape)
    elif process_type == "heston":
        # the BS formulas, xi in sigma's place (reference :619-630,
        # :706-717, :885-887)
        mean_b = _bs_mean(prev, dt, p.get("mu", 0.0))
        var_b = _bs_var(prev, dt, p.get("mu", 0.0), p.get("xi", 0.5))
    elif process_type == "hybrid_ou_bs":
        sw = switch_times if switch_times is not None else p.get("switch_time")
        if sw is None:
            # random switch times with no record: no truths; zeros disable
            # the relative loss (reference :854-858)
            mean_b = var_b = torch.zeros_like(prev)
            disabled = True
        else:
            sw_arr = torch.broadcast_to(
                torch.as_tensor(sw, dtype=dtype, device=values.device),
                (B,))[:, None, None]
            t = times[..., None]                                # (B, N, 1)
            t_prev = torch.cat([times[:, :1], times[:, :-1]], dim=1)[..., None]
            in_ou = t < sw_arr
            prev_in_ou = t_prev < sw_arr
            # the first observation of a regime's subsequence: slot 0, or
            # the regime changed
            regime_first = first | (prev_in_ou != in_ou)
            mean_ou = _ou_mean(prev, dt, p.get("theta_ou", 1.0),
                               p.get("mu_ou", 0.0))
            mean_bs = _bs_mean(prev, dt, p.get("mu_bs", 0.0))
            var_ou = torch.broadcast_to(
                _ou_var(dt, p.get("theta_ou", 1.0), p.get("sigma_ou", 0.3)),
                prev.shape)
            var_bs = _bs_var(prev, dt, p.get("mu_bs", 0.0),
                             p.get("sigma_bs", 0.2))
            mean_b = torch.where(in_ou, mean_ou, mean_bs)
            var_b = torch.where(in_ou, var_ou, var_bs)
            # a regime's first before-value = the observation itself, var 0
            # (reference :564-573 per regime subsequence, :744-761)
            mean_b = torch.where(regime_first, values, mean_b)
            var_b = torch.where(regime_first, 0.0, var_b)
            hybrid_regime = (in_ou, regime_first)
    else:
        raise ValueError(
            f"Unknown process type for conditional moments: {process_type}")

    if disabled:
        mean_after = mean_before = torch.zeros_like(values)
        var_after = var_before = torch.zeros_like(values)
    else:
        mean_after = values
        mean_before = torch.where(first, values, mean_b)
        var_after = torch.zeros_like(values)
        var_before = torch.where(first, 0.0, var_b)

    moments, moments_before = [mean_after], [mean_before]
    if num_moments > 1:
        if variance_method == "direct":
            moments.append(var_after)
            moments_before.append(var_before)
        elif variance_method == "second_moment":
            # E[X^2] = Var + E[X]^2 (reference :910-913)
            moments.append(var_after + _ipow(mean_after, 2))
            moments_before.append(var_before + _ipow(mean_before, 2))
        else:
            raise ValueError(f"Unknown variance_method: {variance_method}")
    # moments >= 3: central moments (0 after a jump) for 'direct', raw
    # moments E[X^p] (X^p after a jump) for 'second_moment', up to the 4th;
    # exact for BS, OU and hybrid (per regime).  Heston's higher moments
    # have no closed form, so they are refused, not approximated.
    if num_moments > 2 and process_type == "heston":
        raise ValueError(
            "Extended moments (num_moments > 2) are unsupported for "
            "'heston': higher conditional moments of the Heston price have "
            "no closed form (the BS approximation used for mean/variance "
            "does not extend).  Use num_moments <= 2, or a family with "
            "exact truths (black_scholes / ornstein_uhlenbeck / "
            "hybrid_ou_bs with recorded switch times).")
    raw = variance_method == "second_moment"
    for m_idx in range(len(moments), num_moments):
        p_ord = m_idx + 1
        if disabled or p_ord > 4:
            moments.append(torch.zeros_like(values))
            moments_before.append(torch.zeros_like(values))
            continue
        if process_type == "ornstein_uhlenbeck":
            th, mu_, sg = (p.get("theta", 1.0), p.get("mu", 0.0),
                           p.get("sigma", 0.3))
            mb_k = (_ou_raw_moment(prev, dt, th, mu_, sg, p_ord) if raw
                    else _ou_central_moment(prev, dt, th, sg, p_ord))
        elif process_type == "black_scholes":
            mu_, sg = p.get("mu", 0.0), p.get("sigma", 0.2)
            mb_k = (_bs_raw_moment(prev, dt, mu_, sg, p_ord) if raw
                    else _bs_central_moment(prev, dt, mu_, sg, p_ord))
        else:  # hybrid: per-regime closed forms, regime_first convention
            in_ou, regime_first = hybrid_regime
            th, mu_o, sg_o = (p.get("theta_ou", 1.0), p.get("mu_ou", 0.0),
                              p.get("sigma_ou", 0.3))
            mu_b, sg_b = p.get("mu_bs", 0.0), p.get("sigma_bs", 0.2)
            if raw:
                ou_k = _ou_raw_moment(prev, dt, th, mu_o, sg_o, p_ord)
                bs_k = _bs_raw_moment(prev, dt, mu_b, sg_b, p_ord)
            else:
                ou_k = _ou_central_moment(prev, dt, th, sg_o, p_ord)
                bs_k = _bs_central_moment(prev, dt, mu_b, sg_b, p_ord)
            mb_k = torch.where(in_ou, ou_k, bs_k)
            # a regime's first before-value follows the jump convention
            mb_k = torch.where(regime_first,
                               _ipow(values, p_ord) if raw else 0.0, mb_k)
        if raw:
            after_k = _ipow(values, p_ord)
            mb_k = torch.where(first, after_k, mb_k)
        else:
            after_k = torch.zeros_like(values)
            mb_k = torch.where(first, 0.0, mb_k)
        moments.append(after_k)
        moments_before.append(mb_k)

    return _masked(torch.stack(moments, dim=-1),
                   torch.stack(moments_before, dim=-1), mask)


def get_conditional_moments_at_obs(batch_times, batch_values,
                                   process_type: str, num_moments: int = 1,
                                   variance_method: str = "direct",
                                   **process_params):
    """Reference-API wrapper (data_generation.py:819-922): ragged lists in,
    lists of (n_i, d, K) out; or dense tensors in, the dense (B, N, d, K)
    pair out.  Other config keys in ``process_params`` are ignored, as the
    reference's ``.get`` lookups ignore them."""
    if isinstance(batch_values, (list, tuple)):
        from ..models.jump_ode import pad_ragged
        device = torch.as_tensor(batch_values[0]).device
        times, values, mask = pad_ragged(batch_times, batch_values,
                                         device=device)
        m, mb = moments_at_obs(times, values, process_type, num_moments,
                               variance_method, mask, **process_params)
        lengths = [int(torch.as_tensor(t).reshape(-1).shape[0])
                   for t in batch_times]
        return ([m[b, :n] for b, n in enumerate(lengths)],
                [mb[b, :n] for b, n in enumerate(lengths)])
    return moments_at_obs(batch_times, batch_values, process_type,
                          num_moments, variance_method, **process_params)


# --------------------------------------------------------------------------
# conditional expectation / variance on the dense grid (for plotting)
# --------------------------------------------------------------------------

def _last_obs(times_full: Tensor, obs_times: Tensor) -> Tensor:
    idx = torch.clamp(torch.searchsorted(obs_times, times_full, right=True)
                      - 1, 0, obs_times.shape[0] - 1)
    return obs_times[idx]


def _value_at(times_full: Tensor, X_full: Tensor, T_i: Tensor) -> Tensor:
    return X_full[torch.searchsorted(times_full, T_i)]


def condexp_black_scholes_on_grid(times_full: Tensor, X_full: Tensor,
                                  obs_times: Tensor, mu: float) -> Tensor:
    """E[X_t | last obs] on the dense grid (reference :417-438)."""
    T_i = _last_obs(times_full, obs_times)
    return _value_at(times_full, X_full, T_i) * torch.exp(
        mu * (times_full - T_i))


def condexp_ou_on_grid(times_full: Tensor, X_full: Tensor, obs_times: Tensor,
                       theta: float, mu: float) -> Tensor:
    T_i = _last_obs(times_full, obs_times)
    decay = torch.exp(-theta * (times_full - T_i))
    return _value_at(times_full, X_full, T_i) * decay + mu * (1.0 - decay)


def condexp_heston_on_grid(times_full: Tensor, X_full: Tensor,
                           obs_times: Tensor, mu: float) -> Tensor:
    return condexp_black_scholes_on_grid(times_full, X_full, obs_times, mu)


def condvar_black_scholes_on_grid(times_full: Tensor, X_full: Tensor,
                                  obs_times: Tensor, mu: float,
                                  sigma: float) -> Tensor:
    T_i = _last_obs(times_full, obs_times)
    X_i = _value_at(times_full, X_full, T_i)
    s = times_full - T_i
    var = (_ipow(X_i, 2) * (torch.exp(sigma ** 2 * s) - 1.0)
           * torch.exp(2.0 * mu * s))
    return torch.where(torch.isclose(times_full, T_i, atol=1e-6), 0.0, var)


def condvar_ou_on_grid(times_full: Tensor, X_full: Tensor, obs_times: Tensor,
                       theta: float, sigma: float) -> Tensor:
    T_i = _last_obs(times_full, obs_times)
    s = times_full - T_i
    var = sigma ** 2 / (2.0 * theta) * (1.0 - torch.exp(-2.0 * theta * s))
    return torch.where(torch.isclose(times_full, T_i, atol=1e-6), 0.0, var)


def condvar_heston_on_grid(times_full: Tensor, X_full: Tensor,
                           obs_times: Tensor, mu: float,
                           sigma: float) -> Tensor:
    return condvar_black_scholes_on_grid(times_full, X_full, obs_times, mu,
                                         sigma)


def condexp_hybrid_on_grid(times_full: Tensor, X_full: Tensor,
                           obs_times: Tensor, switch_time: float,
                           theta_ou: float, mu_ou: float,
                           mu_bs: float) -> Tensor:
    """Regime-aware conditional expectation on the grid (reference
    :296-414): from the last observation; an interval that crosses the
    switch evolves OU to the switch, then BS onward."""
    T_i = _last_obs(times_full, obs_times)
    j = torch.searchsorted(times_full, T_i)         # grid index of last obs
    X_i = X_full[j]
    i = torch.arange(times_full.shape[0], device=times_full.device)
    switch_idx = torch.argmin(torch.abs(times_full - switch_time))
    t_switch = times_full[switch_idx]

    crossing = (j < switch_idx) & (switch_idx <= i)
    decay_sw = torch.exp(-theta_ou * (t_switch - T_i))
    x_at_switch = X_i * decay_sw + mu_ou * (1.0 - decay_sw)
    ce_cross = x_at_switch * torch.exp(mu_bs * (times_full - t_switch))
    s = times_full - T_i
    decay = torch.exp(-theta_ou * s)
    ce_ou = X_i * decay + mu_ou * (1.0 - decay)
    ce_bs = X_i * torch.exp(mu_bs * s)
    ce_plain = torch.where(times_full < switch_time, ce_ou, ce_bs)
    return torch.where(crossing, ce_cross, ce_plain)
