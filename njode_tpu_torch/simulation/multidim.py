"""Multi-dimensional correlated SDE processes (port of
``njode_tpu.simulation.multidim``).

* ``bs_paths_nd``: d-dimensional correlated geometric Brownian motion, exact
  log-Euler (componentwise lognormal, the driving Brownians correlated by a
  Cholesky factor of the correlation matrix).
* ``ou_paths_nd``: d-dimensional OU with componentwise mean reversion and
  correlated driving noise, by the exact one-step law: the per-step noise
  covariance is
      C_ij = sigma_i sigma_j rho_ij (1 - e^{-(theta_i+theta_j) dt})
             / (theta_i + theta_j)
  (sigma_i sigma_j rho_ij dt in the limit theta_i + theta_j -> 0), and the
  linear recurrence is one affine prefix (``sde.affine_prefix``).

Both are registered at import as ``"black_scholes_nd"`` and
``"ornstein_uhlenbeck_nd"`` with their exact observation-time samplers and
componentwise closed-form moments (the NJ-ODE loss is componentwise, so the
marginal moments are what the relative loss needs; the driving correlation
moves only cross-moments).  As in ``sde.py``, each generator draws its
normals and then applies a deterministic transform (``_*_from_normals``).
Conventions follow ``moments.py``: after-jump truth = the observation /
variance 0; before-jump truth = the closed-form propagation from the
previous observation; the first observation's before-value = itself / 0.
"""

from __future__ import annotations

import torch

from .moments import _bs_mean, _bs_var, _ipow, _ou_mean, _ou_var
from .registry import register_process
from .sde import _grid, _normals, affine_prefix

Tensor = torch.Tensor


def _vec(x, d: int, dtype, device) -> Tensor:
    """A scalar, tuple, list or tensor parameter broadcast to shape (d,)."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=device),
                              (d,))


def _corr_chol(corr, d: int, dtype, device) -> Tensor:
    """Cholesky factor of the driving-noise correlation matrix (identity
    for None)."""
    if corr is None:
        return torch.eye(d, dtype=dtype, device=device)
    R = torch.as_tensor(corr, dtype=dtype, device=device)
    if tuple(R.shape) != (d, d):
        raise ValueError(f"corr must be ({d}, {d}), got {tuple(R.shape)}")
    return torch.linalg.cholesky_ex(R).L


def _ou_cov(th: Tensor, sig: Tensor, R: Tensor, s) -> Tensor:
    """C_ij(s) of the module docstring for a gap s (a float, or a tensor
    ending in (1, 1))."""
    th_sum = th[:, None] + th[None, :]
    pos = th_sum > 1e-12
    frac = torch.where(pos, (1.0 - torch.exp(-th_sum * s))
                       / torch.where(pos, th_sum, 1.0), s)
    return sig[:, None] * sig[None, :] * R * frac


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------

def _bs_nd_from_normals(z: Tensor, mu=0.0, sigma=0.2, corr=None,
                        T: float = 1.0, n_steps: int = 100,
                        x0=1.0) -> Tensor:
    """X (B, n+1, d) of :func:`bs_paths_nd` from its normals z (B, n, d)."""
    d, dtype, dev = z.shape[-1], z.dtype, z.device
    dt = T / n_steps
    mu_v, sig_v, x0_v = (_vec(v, d, dtype, dev) for v in (mu, sigma, x0))
    L = _corr_chol(corr, d, dtype, dev)
    dW = torch.einsum("btd,ed->bte", z, L) * torch.sqrt(
        torch.tensor(dt, dtype=dtype, device=dev))
    log_inc = (mu_v - 0.5 * _ipow(sig_v, 2)) * dt + sig_v * dW
    logX = torch.cat([torch.zeros_like(z[:, :1]),
                      torch.cumsum(log_inc, dim=1)], dim=1) + torch.log(x0_v)
    return torch.exp(logX)


def bs_paths_nd(n_paths: int, dims: int = 2, mu=0.0, sigma=0.2, corr=None,
                T: float = 1.0, n_steps: int = 100, x0=1.0, *,
                generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32):
    """Correlated d-dimensional geometric Brownian motion, exact in law on
    the grid: componentwise ``X_j(t+dt) = X_j(t) exp((mu_j - sigma_j^2/2)
    dt + sigma_j dW_j)`` with ``Corr(dW_i, dW_j) = rho_ij``.

    Args:
      dims: d.  mu, sigma, x0: scalars or length-d per-component values.
      corr: (d, d) correlation matrix of the driving Brownians (None: iid).

    Returns: (times (n_steps+1,), X (n_paths, n_steps+1, d)).
    """
    z = _normals(generator, (n_paths, n_steps, int(dims)), dtype)
    X = _bs_nd_from_normals(z, mu, sigma, corr, T, n_steps, x0)
    return _grid(T, n_steps, dtype, device or z.device), X.to(device)


def _ou_nd_from_normals(z: Tensor, theta=1.0, mu=0.0, sigma=0.3, corr=None,
                        T: float = 1.0, n_steps: int = 100,
                        x0=0.0) -> Tensor:
    """X (B, n+1, d) of :func:`ou_paths_nd` from its normals z (B, n, d)."""
    B, _, d = z.shape
    dtype, dev = z.dtype, z.device
    dt = T / n_steps
    th, mu_v, sig_v, x0_v = (_vec(v, d, dtype, dev)
                             for v in (theta, mu, sigma, x0))
    R = (torch.eye(d, dtype=dtype, device=dev) if corr is None
         else torch.as_tensor(corr, dtype=dtype, device=dev))
    a = torch.exp(-th * dt)                                   # (d,)
    L = torch.linalg.cholesky_ex(_ou_cov(th, sig_v, R, dt)).L
    u = mu_v * (1.0 - a) + torch.einsum("btd,ed->bte", z, L)  # (B, T, d)
    A_c, U_c = affine_prefix(torch.broadcast_to(a, u.shape), u, 1)
    return torch.cat([torch.broadcast_to(x0_v, (B, 1, d)), A_c * x0_v + U_c],
                     dim=1)


def ou_paths_nd(n_paths: int, dims: int = 2, theta=1.0, mu=0.0, sigma=0.3,
                corr=None, T: float = 1.0, n_steps: int = 100, x0=0.0, *,
                generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32):
    """Correlated d-dimensional Ornstein-Uhlenbeck, exact discretization:
    ``dX_j = theta_j (mu_j - X_j) dt + sigma_j dW_j`` with ``Corr(dW_i,
    dW_j) = rho_ij``, one step the affine map ``X_{k+1} = a X_k + mu (1 - a)
    + eta_k``, ``a_j = e^{-theta_j dt}``, ``eta ~ N(0, C)``.

    Returns: (times (n_steps+1,), X (n_paths, n_steps+1, d)).
    """
    z = _normals(generator, (n_paths, n_steps, int(dims)), dtype)
    X = _ou_nd_from_normals(z, theta, mu, sigma, corr, T, n_steps, x0)
    return _grid(T, n_steps, dtype, device or z.device), X.to(device)


# --------------------------------------------------------------------------
# exact observation-time samplers (obs_only, cf. sde.py)
# --------------------------------------------------------------------------

def _bs_nd_values_from_normals(times: Tensor, z: Tensor, mu=0.0, sigma=0.2,
                               corr=None, x0=1.0) -> Tensor:
    """Values (B, N, d) of :func:`bs_nd_values_at` from its normals z
    (B, N-1, d)."""
    d, dtype, dev = z.shape[-1], z.dtype, z.device
    dts = times[:, 1:] - times[:, :-1]                        # (B, N-1)
    mu_v, sig_v, x0_v = (_vec(v, d, dtype, dev) for v in (mu, sigma, x0))
    L = _corr_chol(corr, d, dtype, dev)
    dW = torch.einsum("bnd,ed->bne", z, L) * torch.sqrt(dts)[..., None]
    inc = (mu_v - 0.5 * _ipow(sig_v, 2)) * dts[..., None] + sig_v * dW
    logX = torch.cat([torch.zeros_like(z[:, :1]),
                      torch.cumsum(inc, dim=1)], dim=1) + torch.log(x0_v)
    return torch.exp(logX)


def bs_nd_values_at(times: Tensor, dims: int = 2, mu=0.0, sigma=0.2,
                    corr=None, x0=1.0, *, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> Tensor:
    """Exact correlated d-dim GBM samples at per-row sorted times (B, N):
    one correlated lognormal increment per gap, the law of
    grid-simulate-then-subsample."""
    times = times.to(dtype)
    z = _normals(generator, (times.shape[0], times.shape[1] - 1, int(dims)),
                 dtype).to(times.device)
    return _bs_nd_values_from_normals(times, z, mu, sigma, corr, x0)


def _ou_nd_values_from_normals(times: Tensor, z: Tensor, theta=1.0, mu=0.0,
                               sigma=0.3, corr=None, x0=0.0) -> Tensor:
    """Values (B, N, d) of :func:`ou_nd_values_at` from its normals z
    (B, N-1, d)."""
    d, dtype, dev = z.shape[-1], z.dtype, z.device
    dts = times[:, 1:] - times[:, :-1]                        # (B, N-1)
    th, mu_v, sig_v, x0_v = (_vec(v, d, dtype, dev)
                             for v in (theta, mu, sigma, x0))
    R = (torch.eye(d, dtype=dtype, device=dev) if corr is None
         else torch.as_tensor(corr, dtype=dtype, device=dev))
    A = torch.exp(-th * dts[..., None])                       # (B, N-1, d)
    C = _ou_cov(th, sig_v, R, dts[..., None, None])           # (B, N-1, d, d)
    # a small diagonal jitter keeps the batched Cholesky stable at dt -> 0
    C = C + 1e-12 * torch.eye(d, dtype=dtype, device=dev)
    L = torch.linalg.cholesky_ex(C).L
    u = mu_v * (1.0 - A) + torch.einsum("bnde,bne->bnd", L, z)
    A_c, U_c = affine_prefix(A, u, 1)
    return torch.cat([torch.broadcast_to(x0_v, (times.shape[0], 1, d)),
                      A_c * x0_v + U_c], dim=1)


def ou_nd_values_at(times: Tensor, dims: int = 2, theta=1.0, mu=0.0,
                    sigma=0.3, corr=None, x0=0.0, *,
                    generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> Tensor:
    """Exact correlated d-dim OU samples at per-row sorted times (B, N): the
    per-gap exact AR(1) with the gap's noise covariance C(s) (one batched
    Cholesky), then one affine prefix."""
    times = times.to(dtype)
    z = _normals(generator, (times.shape[0], times.shape[1] - 1, int(dims)),
                 dtype).to(times.device)
    return _ou_nd_values_from_normals(times, z, theta, mu, sigma, corr, x0)


# --------------------------------------------------------------------------
# analytic conditional moments (componentwise marginals)
# --------------------------------------------------------------------------

def _nd_moments(values: Tensor, mean_b: Tensor, var_b: Tensor,
                num_moments: int, variance_method: str):
    """(moments, moments_before) from the before-jump mean and variance, in
    ``moments_at_obs``'s conventions; moments >= 3 are zero."""
    B, N, _ = values.shape
    first = torch.zeros((B, N, 1), dtype=torch.bool, device=values.device)
    first[:, 0] = True
    mean_before = torch.where(first, values, mean_b)
    var_after = torch.zeros_like(values)
    var_before = torch.where(first, 0.0, var_b)
    moments, moments_before = [values], [mean_before]
    if num_moments > 1:
        if variance_method == "direct":
            moments.append(var_after)
            moments_before.append(var_before)
        elif variance_method == "second_moment":
            moments.append(var_after + _ipow(values, 2))
            moments_before.append(var_before + _ipow(mean_before, 2))
        else:
            raise ValueError(f"Unknown variance_method: {variance_method}")
    for _ in range(len(moments), num_moments):
        moments.append(torch.zeros_like(values))
        moments_before.append(torch.zeros_like(values))
    return torch.stack(moments, dim=-1), torch.stack(moments_before, dim=-1)


def _dt_prev(times: Tensor, values: Tensor):
    dt = torch.cat([torch.zeros_like(times[:, :1]),
                    times[:, 1:] - times[:, :-1]], dim=1)[..., None]
    return dt, torch.cat([values[:, :1], values[:, :-1]], dim=1)


def bs_nd_moments(times: Tensor, values: Tensor, num_moments: int = 1,
                  variance_method: str = "direct", mu=0.0, sigma=0.2,
                  **_ignored):
    """Componentwise lognormal conditional moments for ``black_scholes_nd``."""
    d, dtype, dev = values.shape[-1], values.dtype, values.device
    mu_v, sig_v = _vec(mu, d, dtype, dev), _vec(sigma, d, dtype, dev)
    dt, prev = _dt_prev(times, values)
    return _nd_moments(values, _bs_mean(prev, dt, mu_v),
                       _bs_var(prev, dt, mu_v, sig_v), num_moments,
                       variance_method)


def ou_nd_moments(times: Tensor, values: Tensor, num_moments: int = 1,
                  variance_method: str = "direct", theta=1.0, mu=0.0,
                  sigma=0.3, **_ignored):
    """Componentwise OU conditional moments for ``ornstein_uhlenbeck_nd``:
    the driving correlation moves only cross-covariances, so the 1-d
    closed forms hold per component (sigma_j^2 dt as theta_j -> 0)."""
    d, dtype, dev = values.shape[-1], values.dtype, values.device
    th, mu_v, sig_v = (_vec(v, d, dtype, dev) for v in (theta, mu, sigma))
    dt, prev = _dt_prev(times, values)
    pos = th > 1e-12
    var_j = torch.where(pos, _ou_var(dt, torch.where(pos, th, 1.0), sig_v),
                        _ipow(sig_v, 2) * dt)
    return _nd_moments(values, _ou_mean(prev, dt, th, mu_v),
                       torch.broadcast_to(var_j, prev.shape), num_moments,
                       variance_method)


register_process("black_scholes_nd", bs_paths_nd, moments_fn=bs_nd_moments,
                 obs_values_fn=bs_nd_values_at)
register_process("ornstein_uhlenbeck_nd", ou_paths_nd,
                 moments_fn=ou_nd_moments, obs_values_fn=ou_nd_values_at)
