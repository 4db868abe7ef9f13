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
                                        ("black_scholes", {"obs_only": True})])
def test_unported_processes_raise(process, kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        simulate_batch(4, process, generator=gen(0), **kw)


def test_values_are_float32_and_finite():
    b = simulate_batch(16, "black_scholes", generator=gen(6), sigma=0.5)
    assert b.values.dtype == torch.float32
    assert np.isfinite(b.values.numpy()).all()
