"""The port's closed-form conditional moments for every process family, the
reference-API moment helpers and the evaluation metrics, held against the
JAX package on identical inputs on the CPU.

Tolerances: rtol 1e-5 / atol 1e-6 (f32 exp/pow rounding); the extended
central moments of the BS regimes (``direct``, moments >= 3) sum a
binomial expansion whose f32 terms cancel, so an ulp of exp in either
package moves them by up to about 1e-5: atol 2e-5 there (the trap in
ROADMAP's Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.simulation import moments as jmom
from njode_tpu.simulation.sde import TrajectoryBatch as JaxBatch
from njode_tpu.utils import metrics as jmetrics
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.simulation import (TrajectoryBatch,
                                        get_conditional_moments_at_obs,
                                        moments_at_obs)
from njode_tpu_torch.simulation import moments as mom
from njode_tpu_torch.utils import (conditional_moment_mse, relative_loss,
                                   state_dict_from_jax)

TOL = dict(rtol=1e-5, atol=1e-6)

PARAMS = {
    "black_scholes": dict(mu=0.1, sigma=0.5),
    "ornstein_uhlenbeck": dict(theta=1.5, mu=0.5, sigma=0.3),
    "heston": dict(mu=0.5, kappa=2.0, theta=0.04, xi=0.5, rho=-0.5),
    "hybrid_ou_bs": dict(theta_ou=1.0, mu_ou=0.5, sigma_ou=0.3, mu_bs=0.1,
                         sigma_bs=0.2, switch_time=0.45),
}


def case(seed, B=6, N=9, d=1, masked=False):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 1, (B, N)), axis=1).astype(np.float32)
    times[:, 0] = 0.0
    values = rng.lognormal(0, 0.3, (B, N, d)).astype(np.float32)
    mask = np.ones((B, N), bool)
    if masked:
        mask[:2, N - 3:] = False
    return times, values, mask


def assert_moments_close(ours, ref, method):
    for a, b in zip(ours, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a[..., :2], b[..., :2], **TOL)
        np.testing.assert_allclose(
            a[..., 2:], b[..., 2:], rtol=1e-5,
            atol=2e-5 if method == "direct" else 1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("K,method", [(1, "direct"), (2, "direct"),
                                      (2, "second_moment"), (4, "direct"),
                                      (4, "second_moment"), (5, "direct")])
@pytest.mark.parametrize("process", list(PARAMS))
def test_moments_at_obs_matches_jax(process, K, method, masked):
    times, values, mask = case(K + 7 * masked)
    kw = dict(num_moments=K, variance_method=method, n_train=3,
              **PARAMS[process])
    if process == "heston" and K > 2:
        with pytest.raises(ValueError, match="Extended moments"):
            moments_at_obs(torch.tensor(times), torch.tensor(values),
                           process, mask=torch.tensor(mask), **kw)
        with pytest.raises(ValueError, match="Extended moments"):
            jmom.moments_at_obs(times, values, process, mask=mask, **kw)
        return
    ours = moments_at_obs(torch.tensor(times), torch.tensor(values), process,
                          mask=torch.tensor(mask), **kw)
    ref = jmom.moments_at_obs(times, values, process, mask=mask, **kw)
    assert_moments_close(ours, ref, method)


@pytest.mark.parametrize("K,method", [(2, "direct"), (4, "second_moment"),
                                      (4, "direct")])
@pytest.mark.parametrize("record", ["switch_times", "none"])
def test_hybrid_switch_time_records(record, K, method):
    """Per-path switch times, some before the first slot's successor and
    some past the last: the regime_first convention per path; no record
    and a random switch: zero truths, as the JAX package returns."""
    times, values, mask = case(3, masked=True)
    p = dict(PARAMS["hybrid_ou_bs"])
    p.pop("switch_time")
    sw = (np.array([0.0, 0.2, 0.45, 0.6, 0.8, 1.5], np.float32)
          if record == "switch_times" else None)
    kw = dict(num_moments=K, variance_method=method, **p)
    ours = moments_at_obs(torch.tensor(times), torch.tensor(values),
                          "hybrid_ou_bs", mask=torch.tensor(mask),
                          switch_times=(None if sw is None
                                        else torch.tensor(sw)), **kw)
    ref = jmom.moments_at_obs(times, values, "hybrid_ou_bs", mask=mask,
                              switch_times=sw, **kw)
    assert_moments_close(ours, ref, method)
    if sw is None:
        assert all(bool(torch.all(x == 0)) for x in ours)


def test_ou_higher_moments_are_the_gaussian_ones():
    """The OU raw moments up to the 4th from N(m, v), checked against
    float64 Gauss-Hermite quadrature of the conditional law."""
    prev = torch.tensor([[0.3], [1.2]], dtype=torch.float64)
    dt = torch.tensor([[0.2], [0.7]], dtype=torch.float64)
    m = mom._ou_mean(prev, dt, 1.5, 0.5)
    v = mom._ou_var(dt, 1.5, 0.3)
    x, w = np.polynomial.hermite_e.hermegauss(20)
    x, w = torch.tensor(x), torch.tensor(w) / np.sqrt(2 * np.pi)
    for p in (1, 2, 3, 4):
        quad = ((m + v.sqrt() * x) ** p * w).sum(-1, keepdim=True)
        torch.testing.assert_close(
            mom._ou_raw_moment(prev, dt, 1.5, 0.5, 0.3, p), quad,
            rtol=1e-12, atol=1e-12)
    for p, want in ((2, v), (3, torch.zeros_like(v)), (4, 3 * v * v)):
        torch.testing.assert_close(mom._ou_central_moment(prev, dt, 1.5,
                                                          0.3, p), want)


@pytest.mark.parametrize("process", ["ornstein_uhlenbeck", "hybrid_ou_bs",
                                     "heston"])
def test_get_conditional_moments_at_obs_matches_jax(process):
    """Ragged lists (lists out, one per trajectory) and dense arrays."""
    times, values, _ = case(5)
    lengths = [9, 5, 7, 9, 3, 6]
    bt = [times[b, :n] for b, n in enumerate(lengths)]
    bv = [values[b, :n] for b, n in enumerate(lengths)]
    kw = dict(num_moments=2, variance_method="direct", **PARAMS[process])
    ours = get_conditional_moments_at_obs(
        [torch.tensor(x) for x in bt], [torch.tensor(x) for x in bv],
        process, **kw)
    ref = jmom.get_conditional_moments_at_obs(bt, bv, process, **kw)
    for a_list, b_list in zip(ours, ref):
        assert len(a_list) == len(lengths)
        for a, b, n in zip(a_list, b_list, lengths):
            assert a.shape == (n, 1, 2)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    dense = get_conditional_moments_at_obs(torch.tensor(times),
                                           torch.tensor(values), process,
                                           **kw)
    ref = jmom.get_conditional_moments_at_obs(jnp.asarray(times),
                                              jnp.asarray(values), process,
                                              **kw)
    for a, b in zip(dense, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


GRID_FNS = {
    "condexp_black_scholes_on_grid": dict(mu=0.1),
    "condexp_ou_on_grid": dict(theta=1.5, mu=0.5),
    "condexp_heston_on_grid": dict(mu=0.5),
    "condvar_black_scholes_on_grid": dict(mu=0.1, sigma=0.5),
    "condvar_ou_on_grid": dict(theta=1.5, sigma=0.3),
    "condvar_heston_on_grid": dict(mu=0.5, sigma=0.5),
    "condexp_hybrid_on_grid": dict(switch_time=0.43, theta_ou=1.0,
                                   mu_ou=0.5, mu_bs=0.1),
}


@pytest.mark.parametrize("name", list(GRID_FNS))
def test_on_grid_functions_match_jax(name):
    rng = np.random.default_rng(1)
    times_full = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    X_full = rng.lognormal(0, 0.3, 101).astype(np.float32)
    obs_times = times_full[np.array([0, 7, 30, 44, 61, 100])]
    from njode_tpu_torch import simulation as sim
    from njode_tpu import simulation as jsim
    ours = getattr(sim, name)(torch.tensor(times_full), torch.tensor(X_full),
                              torch.tensor(obs_times), **GRID_FNS[name])
    ref = getattr(jsim, name)(jnp.asarray(times_full), jnp.asarray(X_full),
                              jnp.asarray(obs_times), **GRID_FNS[name])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


# ----------------------------------------------------------------- metrics

H = 12


def bridged(K=2, seed=0):
    cfg = dict(input_dim=1, hidden_dim=H, output_dim=1, num_moments=K)
    jm = JaxModel(use_pallas=False, **cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    port = NeuralJumpODE(**cfg, use_pallas=False, device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=K, shared_network=False, n_hidden_layers=1))
    return jm, params, port


def batches(process, masked=True):
    times, values, mask = case(11, B=8, N=7, masked=masked)
    sw = np.linspace(0.3, 0.7, 8).astype(np.float32)
    grid = np.linspace(0, 1, 101, dtype=np.float32)
    idx = np.zeros(times.shape, np.int32)
    ours = TrajectoryBatch(torch.tensor(times), torch.tensor(values),
                           torch.tensor(mask), torch.tensor(grid),
                           torch.tensor(idx), None, torch.tensor(sw))
    ref = JaxBatch(jnp.asarray(times), jnp.asarray(values), jnp.asarray(mask),
                   jnp.asarray(grid), jnp.asarray(idx), None, jnp.asarray(sw))
    return ours, ref


@pytest.mark.parametrize("process,use_sw", [
    ("ornstein_uhlenbeck", False), ("heston", False), ("hybrid_ou_bs", True),
    ("black_scholes", False)])
@pytest.mark.parametrize("method", ["direct", "second_moment"])
def test_metrics_match_jax(process, use_sw, method):
    jm, params, port = bridged()
    ours_b, ref_b = batches(process)
    p = {k: v for k, v in PARAMS[process].items() if k != "switch_time"}
    kw = dict(variance_method=method, use_batch_switch_times=use_sw, **p)
    rel = relative_loss(port, ours_b, process, moment_weights=[1.0, 10.0],
                        **kw)
    rel_ref = jmetrics.relative_loss(jm, params, ref_b, process,
                                     moment_weights=[1.0, 10.0], **kw)
    np.testing.assert_allclose(rel, rel_ref, rtol=1e-4)
    mse = conditional_moment_mse(port, ours_b, process, **kw)
    mse_ref = jmetrics.conditional_moment_mse(jm, params, ref_b, process,
                                              **kw)
    np.testing.assert_allclose(mse["mean"], mse_ref["mean"], rtol=1e-4)
    np.testing.assert_allclose(mse["var"], mse_ref["var"], rtol=1e-4)


def test_conditional_moment_mse_without_a_variance():
    jm, params, port = bridged(K=1)
    ours_b, ref_b = batches("ornstein_uhlenbeck", masked=False)
    p = PARAMS["ornstein_uhlenbeck"]
    mse = conditional_moment_mse(port, ours_b, "ornstein_uhlenbeck", **p)
    ref = jmetrics.conditional_moment_mse(jm, params, ref_b,
                                          "ornstein_uhlenbeck", **p)
    assert mse["var"] is None and ref["var"] is None
    np.testing.assert_allclose(mse["mean"], ref["mean"], rtol=1e-4)
