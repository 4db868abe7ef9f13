"""The port's Black-Scholes simulator and observation sampler, held by law
(as tests/test_sde.py holds the JAX package's) and against the JAX
package's static shapes.  PyTorch's and JAX's generators give different
numbers from one seed, so nothing random is compared bit for bit.

Statistical checks use a z-bound of 5 standard errors: with the fixed
seeds here they are deterministic, and a correct sampler would fail one
with probability below 1e-6.
"""

import math

import jax
import numpy as np
import pytest
import torch

from njode_tpu.simulation import n_obs_for as jax_n_obs_for
from njode_tpu.simulation import sample_obs_indices as jax_sample_obs_indices
from njode_tpu_torch.simulation import (bs_paths, n_obs_for,
                                        sample_obs_indices, simulate_batch)

Z = 5.0


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("t_index", [50, 100])
def test_bs_log_returns_have_the_black_scholes_law(t_index):
    mu, sigma, n = 0.1, 0.5, 20000
    times, X = bs_paths(n, mu, sigma, T=1.0, n_steps=100, x0=1.0,
                        generator=gen(0))
    assert X.shape == (n, 101) and times.shape == (101,)
    assert torch.all(X[:, 0] == 1.0)
    t = float(times[t_index])
    r = torch.log(X[:, t_index]).double()
    m_true, v_true = (mu - 0.5 * sigma ** 2) * t, sigma ** 2 * t
    assert abs(float(r.mean()) - m_true) < Z * math.sqrt(v_true / n)
    assert abs(float(r.var()) - v_true) < Z * v_true * math.sqrt(2.0 / (n - 1))


@pytest.mark.parametrize("frac,n_grid", [(0.1, 101), (0.05, 101), (0.5, 101),
                                         (0.0, 11), (1.0, 5), (0.3, 3)])
def test_obs_counts_and_invariants_match_jax(frac, n_grid):
    assert n_obs_for(frac, n_grid) == jax_n_obs_for(frac, n_grid)
    idx = sample_obs_indices(64, n_grid, frac, generator=gen(1))
    ref = jax_sample_obs_indices(jax.random.PRNGKey(1), 64, n_grid, frac)
    assert tuple(idx.shape) == tuple(ref.shape)
    assert torch.all(idx[:, 0] == 0) and torch.all(idx[:, -1] == n_grid - 1)
    assert torch.all(idx[:, 1:] > idx[:, :-1])       # sorted and distinct


@pytest.mark.parametrize("frac", [0.1, 0.5], ids=["sparse", "dense"])
def test_interior_observations_are_uniform(frac):
    """Chi-square over the interior grid points (8 and 48 interior points
    of 99)."""
    B, n_grid = 20000, 101
    idx = sample_obs_indices(B, n_grid, frac, generator=gen(2))
    interior = idx[:, 1:-1].reshape(-1)
    counts = torch.bincount(interior, minlength=n_grid)[1:-1].double()
    expected = interior.numel() / (n_grid - 2)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    dof = n_grid - 3
    assert chi2 < dof + Z * math.sqrt(2 * dof), chi2


def test_simulate_batch_grid_branch():
    b = simulate_batch(32, "black_scholes", 0.1, generator=gen(3), mu=0.1,
                       sigma=0.5, x0=2.0, T=1.0, n_steps=100)
    assert b.times.shape == (32, 10) and b.values.shape == (32, 10, 1)
    assert b.n_trajectories == 32 and bool(b.mask.all())
    torch.testing.assert_close(b.times, b.grid_times[b.obs_idx], rtol=0,
                               atol=0)
    torch.testing.assert_close(b.values[..., 0],
                               torch.gather(b.paths, 1, b.obs_idx),
                               rtol=0, atol=0)
    assert torch.all(b.values[:, 0, 0] == 2.0)


def test_simulate_batch_is_deterministic_in_the_generator_seed():
    kw = dict(mu=0.1, sigma=0.5, n_steps=50)
    a = simulate_batch(8, "black_scholes", 0.2, generator=gen(4), **kw)
    b = simulate_batch(8, "black_scholes", 0.2, generator=gen(4), **kw)
    c = simulate_batch(8, "black_scholes", 0.2, generator=gen(5), **kw)
    for name in ("times", "values", "obs_idx", "paths"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert not torch.equal(a.paths, c.paths)


@pytest.mark.parametrize("process,kw", [("ornstein_uhlenbeck", {}),
                                        ("hybrid_ou_bs", {"obs_only": True})])
def test_unported_processes_raise(process, kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        simulate_batch(4, process, generator=gen(0), **kw)


def test_values_are_float32_and_finite():
    b = simulate_batch(16, "black_scholes", generator=gen(6), sigma=0.5)
    assert b.values.dtype == torch.float32
    assert np.isfinite(b.values.numpy()).all()


def test_obs_only_bs_log_increments_have_the_law():
    """Obs-only values: each standardized log-increment is N(0, 1) given its
    gap, (log dX - (mu - sigma^2/2) dt) / (sigma sqrt(dt)); Kolmogorov-Smirnov
    at the 1e-6 level, and the first value is x0."""
    from scipy import stats
    mu, sigma = 0.1, 0.5
    b = simulate_batch(4000, "black_scholes", 0.1, obs_only=True,
                       generator=gen(7), mu=mu, sigma=sigma, x0=1.0)
    assert b.paths is None and b.values.shape == (4000, 10, 1)
    assert torch.all(b.values[:, 0, 0] == 1.0)
    dt = (b.times[:, 1:] - b.times[:, :-1]).double()
    inc = torch.diff(torch.log(b.values[..., 0].double()), dim=1)
    z = ((inc - (mu - 0.5 * sigma ** 2) * dt) / (sigma * dt.sqrt())).numpy()
    assert stats.kstest(z.ravel(), "norm").pvalue > 1e-6


def test_obs_only_times_are_index_arithmetic():
    """times = obs_idx * (T / n_steps) in f32 arithmetic, bitwise the JAX
    package's expression on the same indices (sde.py:505)."""
    import jax.numpy as jnp
    T, n_steps = 1.0, 100
    b = simulate_batch(64, "black_scholes", 0.1, obs_only=True,
                       generator=gen(8), T=T, n_steps=n_steps)
    jax_times = np.asarray(jnp.asarray(b.obs_idx.numpy()).astype(jnp.float32)
                           * (jnp.float32(T) / jnp.float32(n_steps)))
    np.testing.assert_array_equal(b.times.numpy(), jax_times)
    assert torch.all(b.obs_idx[:, 0] == 0) and torch.all(
        b.obs_idx[:, -1] == n_steps)
    assert torch.all(b.mask)


@pytest.mark.parametrize("K,method,masked", [
    (1, "direct", False), (2, "direct", True), (2, "second_moment", False),
    (4, "direct", True), (4, "second_moment", False)])
def test_moments_at_obs_bs_matches_jax(K, method, masked):
    """Closed-form BS truths (after/before jump, variance or second moment,
    and the extended higher moments) equal the JAX package's on the same
    inputs to 1e-6 (f32 exp/pow rounding).  The extended central moments
    (direct, moments >= 2) sum a binomial expansion whose f32 terms reach
    comb(4, 2) X^4 and cancel to about 1e-2, so an ulp of exp in either
    package moves them by up to about 1e-5: atol 2e-5 there."""
    from njode_tpu.simulation.moments import moments_at_obs as jax_moments
    from njode_tpu_torch.simulation import moments_at_obs
    rng = np.random.default_rng(K)
    times = np.sort(rng.uniform(0, 1, (6, 7)), axis=1).astype(np.float32)
    times[:, 0] = 0.0
    values = rng.lognormal(0, 0.3, (6, 7, 1)).astype(np.float32)
    mask = np.ones((6, 7), bool)
    if masked:
        mask[:2, 5:] = False
    kw = dict(num_moments=K, variance_method=method, mu=0.1, sigma=0.5,
              n_train=3)
    ours = moments_at_obs(torch.tensor(times), torch.tensor(values),
                          "black_scholes", mask=torch.tensor(mask), **kw)
    ref = jax_moments(times, values, "black_scholes", mask=mask, **kw)
    for a, b in zip(ours, ref):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a[..., :2], b[..., :2], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(
            a[..., 2:], b[..., 2:], rtol=1e-6,
            atol=2e-5 if method == "direct" else 1e-6)
    with pytest.raises(NotImplementedError, match="not ported"):
        moments_at_obs(torch.tensor(times), torch.tensor(values), "heston")
