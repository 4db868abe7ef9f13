"""The port's 1-d process families (OU, Heston, hybrid OU->BS), the process
registry and the reference-API helpers, held against the JAX package on
the CPU.

* Transforms: each generator draws its normals and applies a deterministic
  transform to them; here the transforms get the JAX package's own normals
  (its key split as the JAX function splits it, drawn with ``jax.random``)
  and must give the JAX function's output at rtol 1e-5 / atol 1e-6 (f32
  roundoff of another scan order and of exp/sqrt).
* Laws: PyTorch's generators give other numbers than JAX's, so the
  generators themselves are held by law: sample means and variances at
  fixed times against the closed forms, and obs-only sampling against
  grid-then-subsample, within 5 standard errors over at least 20,000 paths
  (with these fixed seeds deterministic; a correct sampler fails one with
  probability below 1e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu.simulation import sde as jsde
from njode_tpu_torch.simulation import registry
from njode_tpu_torch.simulation import sde
from njode_tpu_torch.simulation import (
    PROCESS_TYPES, create_trajectory_batch, generate_black_scholes,
    generate_heston, generate_hybrid_ou_bs, generate_ou, heston_paths,
    hybrid_ou_bs_paths, ou_paths, register_process, registered_processes,
    simulate_batch, subsample_random_grid_points, supports_obs_only)
from njode_tpu_torch.utils import run_experiment

TOL = dict(rtol=1e-5, atol=1e-6)
Z = 5.0
N_LAW = 20000


def gen(seed):
    return torch.Generator().manual_seed(seed)


def t(x):
    return torch.tensor(np.asarray(x))


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize("theta", [1.0, 0.0, 40.0], ids=["theta1", "theta0",
                                                          "theta40"])
def test_ou_transform_matches_jax(theta):
    """theta 40 over T 1: the decay exp(-40) needs the affine prefix, not a
    quotient of cumulative products."""
    key = jax.random.PRNGKey(3)
    kw = dict(theta=theta, mu=0.5, sigma=0.3, T=1.0, n_steps=100, x0=0.2)
    _, X = jsde.ou_paths(key, 64, **kw)
    z = jax.random.normal(key, (64, 100))
    np.testing.assert_allclose(sde._ou_from_normals(t(z), **kw).numpy(),
                               np.asarray(X), **TOL)


def test_heston_transform_matches_jax():
    key = jax.random.PRNGKey(4)
    kw = dict(mu=0.5, kappa=2.0, theta=0.04, xi=0.5, rho=-0.5, T=1.0,
              n_steps=100, x0=1.0, v0=0.04)
    _, X, V = jsde.heston_paths(key, 64, **kw)
    k1, k2 = jax.random.split(key)
    z1 = jax.random.normal(k1, (100, 64))
    z2 = jax.random.normal(k2, (100, 64))
    Xp, Vp = sde._heston_from_normals(t(z1), t(z2), **kw)
    np.testing.assert_allclose(Xp.numpy(), np.asarray(X), **TOL)
    np.testing.assert_allclose(Vp.numpy(), np.asarray(V), **TOL)


@pytest.mark.parametrize("switch_time", [None, 0.45], ids=["random", "fixed"])
def test_hybrid_transform_matches_jax(switch_time):
    key = jax.random.PRNGKey(5)
    kw = dict(theta_ou=1.0, mu_ou=0.5, sigma_ou=0.3, mu_bs=0.1,
              sigma_bs=0.2, T=1.0, n_steps=100, x0=1.0)
    _, X, sw = jsde.hybrid_ou_bs_paths(key, 64, switch_time=switch_time,
                                       **kw)
    k_sw, k_ou, k_bs = jax.random.split(key, 3)
    sw_j = (jax.random.uniform(k_sw, (64,), jnp.float32, 0.2, 0.8)
            if switch_time is None else jnp.full((64,), switch_time))
    np.testing.assert_array_equal(np.asarray(sw_j), np.asarray(sw))
    Xp = sde._hybrid_from_normals(t(sw_j), t(jax.random.normal(k_ou,
                                                               (100, 64))),
                                  t(jax.random.normal(k_bs, (100, 64))), **kw)
    np.testing.assert_allclose(Xp.numpy(), np.asarray(X), **TOL)


def _obs_times(seed=6, B=32, N=8):
    """Per-row sorted grid times with times[:, 0] == 0, as obs-only makes
    them."""
    idx = jsde.sample_obs_indices(jax.random.PRNGKey(seed), B, 101, N / 101)
    return jnp.asarray(idx, jnp.float32) * (jnp.float32(1.0)
                                            / jnp.float32(100))


@pytest.mark.parametrize("theta", [1.0, 0.0], ids=["theta1", "theta0"])
def test_ou_values_at_transform_matches_jax(theta):
    key = jax.random.PRNGKey(7)
    times = _obs_times()
    kw = dict(theta=theta, mu=0.5, sigma=0.3, x0=0.1)
    ref = jsde.ou_values_at(key, times, **kw)
    xi = jax.random.normal(key, (times.shape[0], times.shape[1] - 1))
    np.testing.assert_allclose(
        sde._ou_values_from_normals(t(times), t(xi), **kw).numpy(),
        np.asarray(ref), **TOL)


@pytest.mark.parametrize("switch_time", [None, 0.37], ids=["random", "fixed"])
def test_hybrid_values_at_transform_matches_jax(switch_time):
    key = jax.random.PRNGKey(8)
    times = _obs_times(seed=9)
    kw = dict(theta_ou=1.0, mu_ou=0.5, sigma_ou=0.3, mu_bs=0.1,
              sigma_bs=0.2, x0=1.0, T=1.0, n_steps=100)
    ref, sw = jsde.hybrid_values_at(key, times, switch_time=switch_time,
                                    **kw)
    B, N = times.shape
    k_sw, k1, k2 = jax.random.split(key, 3)
    sw_j = (jax.random.uniform(k_sw, (B,), jnp.float32, 0.2, 0.8)
            if switch_time is None else jnp.full((B,), switch_time))
    np.testing.assert_array_equal(np.asarray(sw_j), np.asarray(sw))
    ours = sde._hybrid_values_from_normals(
        t(times), t(sw_j), t(jax.random.normal(k1, (B, N - 1))),
        t(jax.random.normal(k2, (B, N - 1))), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 100])
def test_affine_prefix_is_the_sequential_recurrence(n):
    """In float64 against X_k = a_k X_{k-1} + u_k step by step."""
    rng = np.random.default_rng(n)
    A = torch.tensor(rng.uniform(0.5, 1.5, (3, n)))
    U = torch.tensor(rng.normal(size=(3, n)))
    A_c, U_c = sde.affine_prefix(A, U, 1)
    x = torch.full((3,), 0.7, dtype=torch.float64)
    for k in range(n):
        x = A[:, k] * x + U[:, k]
        torch.testing.assert_close(A_c[:, k] * 0.7 + U_c[:, k], x,
                                   rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------- laws

def _moments(x):
    x = x.double()
    m = x.mean()
    v = x.var()
    m4 = ((x - m) ** 4).mean()
    return float(m), float(v), float(m4)


def _assert_law(x, mean, var, what):
    n = x.numel()
    m, v, m4 = _moments(x)
    assert abs(m - mean) < Z * math.sqrt(var / n), (what, m, mean)
    assert abs(v - var) < Z * math.sqrt(max(m4 - v * v, 1e-30) / n), (
        what, v, var)


def test_ou_paths_have_the_ou_law():
    theta, mu, sigma, x0 = 1.5, 0.5, 0.3, 0.2
    times, X = ou_paths(N_LAW, theta, mu, sigma, x0=x0, generator=gen(0))
    assert X.shape == (N_LAW, 101) and torch.all(X[:, 0] == x0)
    for k in (1, 30, 100):
        tk = float(times[k])
        e = math.exp(-theta * tk)
        _assert_law(X[:, k], x0 * e + mu * (1 - e),
                    sigma ** 2 / (2 * theta) * (1 - math.exp(-2 * theta * tk)),
                    f"t={tk}")


def test_heston_price_mean_and_variance_floor():
    """Under the Euler scheme E[X_k] = x0 (1 + mu dt)^k exactly (dW1 is
    independent of V_k); V never drops below the clamp."""
    mu, x0 = 0.5, 1.0
    times, X, V = heston_paths(N_LAW, mu=mu, x0=x0, generator=gen(1))
    assert X.shape == V.shape == (N_LAW, 101)
    assert torch.all(V >= 1e-6) and torch.all(V[:, 0] == 0.04)
    for k in (10, 100):
        x = X[:, k].double()
        mean = x0 * (1 + mu * 0.01) ** k
        assert abs(float(x.mean()) - mean) < Z * math.sqrt(
            float(x.var()) / N_LAW)


def test_hybrid_paths_have_the_regime_laws():
    """At a fixed switch (0.5, grid index 50): OU's law up to it, then
    lognormal growth from the switch's value."""
    th, mu_o, sg_o, mu_b, sg_b, x0 = 1.0, 0.5, 0.3, 0.1, 0.2, 1.0
    times, X, sw = hybrid_ou_bs_paths(N_LAW, th, mu_o, sg_o, mu_b, sg_b,
                                      x0=x0, switch_time=0.5,
                                      generator=gen(2))
    assert torch.all(sw == 0.5)
    e = math.exp(-th * 0.5)
    m_s = x0 * e + mu_o * (1 - e)
    v_s = sg_o ** 2 / (2 * th) * (1 - math.exp(-2 * th * 0.5))
    _assert_law(X[:, 50], m_s, v_s, "switch")
    s = 0.5
    mean = m_s * math.exp(mu_b * s)
    var = ((v_s + m_s ** 2) * math.exp((2 * mu_b + sg_b ** 2) * s)
           - m_s ** 2 * math.exp(2 * mu_b * s))
    _assert_law(X[:, 100], mean, var, "T")


def test_hybrid_random_switch_is_uniform():
    _, _, sw = hybrid_ou_bs_paths(N_LAW, generator=gen(3))
    assert float(sw.min()) >= 0.2 and float(sw.max()) <= 0.8
    _assert_law(sw, 0.5, 0.6 ** 2 / 12, "switch times")


PROCS = {
    "ornstein_uhlenbeck": dict(theta=1.0, mu=0.5, sigma=0.3, x0=0.0),
    "hybrid_ou_bs": dict(theta_ou=1.0, mu_ou=0.5, sigma_ou=0.3, mu_bs=0.1,
                         sigma_bs=0.2, x0=1.0),
}


@pytest.mark.parametrize("process", list(PROCS))
def test_obs_only_has_the_law_of_grid_then_subsample(process):
    """obs_fraction 1 observes every grid point, so obs-only values and
    grid values share their law at each index; the observation times are
    the grid's."""
    kw = PROCS[process]
    grid = simulate_batch(N_LAW, process, 1.0, generator=gen(4), **kw)
    obs = simulate_batch(N_LAW, process, 1.0, obs_only=True,
                         generator=gen(5), **kw)
    assert obs.paths is None and obs.values.shape == grid.values.shape
    torch.testing.assert_close(obs.times, grid.times, rtol=0, atol=1e-6)
    assert (obs.switch_times is None) == (process != "hybrid_ou_bs")
    for k in (20, 50, 100):
        a, b = grid.values[:, k, 0], obs.values[:, k, 0]
        ma, va, m4a = _moments(a)
        mb, vb, m4b = _moments(b)
        assert abs(ma - mb) < Z * math.sqrt((va + vb) / N_LAW), (k, ma, mb)
        assert abs(va - vb) < Z * math.sqrt(
            (m4a - va ** 2 + m4b - vb ** 2) / N_LAW), (k, va, vb)


# ---------------------------------------------------------- simulate_batch

@pytest.mark.parametrize("process", PROCESS_TYPES)
@pytest.mark.parametrize("obs_only", [False, True], ids=["grid", "obs"])
def test_simulate_batch_every_family(process, obs_only):
    if obs_only and not supports_obs_only(process):
        with pytest.raises(ValueError, match="exact transition law"):
            simulate_batch(8, process, obs_only=True, generator=gen(0))
        return
    b = simulate_batch(8, process, 0.1, obs_only, generator=gen(0))
    assert b.times.shape == (8, 10) and b.values.shape == (8, 10, 1)
    assert bool(torch.isfinite(b.values).all()) and bool(b.mask.all())
    assert (b.switch_times is not None) == (process == "hybrid_ou_bs")
    if not obs_only:
        torch.testing.assert_close(b.values[..., 0],
                                   torch.gather(b.paths, 1, b.obs_idx),
                                   rtol=0, atol=0)
    again = simulate_batch(8, process, 0.1, obs_only, generator=gen(0))
    assert torch.equal(again.values, b.values)


def test_supports_obs_only_matches_jax():
    from njode_tpu.simulation import supports_obs_only as jax_supports
    for name in PROCESS_TYPES + ("black_scholes_nd", "ornstein_uhlenbeck_nd",
                                 "unknown"):
        assert supports_obs_only(name) == jax_supports(name), name


# ---------------------------------------------------------------- registry

@pytest.fixture
def clean_registry():
    saved = [dict(d) for d in (registry._PATHS, registry._MOMENTS,
                               registry._OBS_VALUES)]
    yield
    for d, s in zip((registry._PATHS, registry._MOMENTS,
                     registry._OBS_VALUES), saved):
        d.clear()
        d.update(s)


def _const_paths(n_paths, *, generator, device=None, level=2.0, T=1.0,
                 n_steps=100):
    times = torch.linspace(0.0, T, n_steps + 1)
    noise = torch.rand(n_paths, 1, generator=generator) * 0.0
    return times, torch.full((n_paths, n_steps + 1), level) + noise


def _const_values(times, *, generator, level=2.0):
    return torch.full(times.shape, level)


def test_register_process_without_obs_values(clean_registry):
    register_process("const", _const_paths)
    assert "const" in registered_processes()
    assert not supports_obs_only("const")
    b = simulate_batch(4, "const", 0.1, generator=gen(0), level=3.0)
    assert b.values.shape == (4, 10, 1) and torch.all(b.values == 3.0)
    with pytest.raises(ValueError, match="exact transition law"):
        simulate_batch(4, "const", obs_only=True, generator=gen(0))


def test_register_process_with_obs_values(clean_registry):
    register_process("const", _const_paths, obs_values_fn=_const_values)
    assert supports_obs_only("const")
    b = simulate_batch(4, "const", 0.1, obs_only=True, generator=gen(0),
                       level=5.0)
    assert b.paths is None and torch.all(b.values == 5.0)
    # re-registering without it clears the sampler
    register_process("const", _const_paths)
    assert not supports_obs_only("const")
    assert registry.get_obs_values_fn("const") is None


def test_registered_generator_overrides_a_builtin_name(clean_registry):
    """A paths_fn under a built-in name wins in simulate_batch and turns
    the built-in obs-only sampler off, as in the JAX package."""
    register_process("ornstein_uhlenbeck", _const_paths)
    assert not supports_obs_only("ornstein_uhlenbeck")
    b = simulate_batch(4, "ornstein_uhlenbeck", generator=gen(0))
    assert torch.all(b.values == 2.0)


def test_registered_extra_becomes_switch_times(clean_registry):
    def paths(n_paths, *, generator, device=None):
        times, X = _const_paths(n_paths, generator=generator)
        return times, X, torch.arange(n_paths, dtype=torch.float32)
    register_process("with_extra", paths)
    b = simulate_batch(3, "with_extra", generator=gen(0))
    assert torch.equal(b.switch_times, torch.arange(3.0))


# ------------------------------------------------------- reference helpers

def test_create_trajectory_batch_shapes_and_seed():
    bt, bv = create_trajectory_batch(5, "ornstein_uhlenbeck", 0.1, seed=3,
                                     device="cpu")
    assert len(bt) == len(bv) == 5
    assert bt[0].shape == (10,) and bv[0].shape == (10, 1)
    bt2, bv2 = create_trajectory_batch(5, "ornstein_uhlenbeck", 0.1, seed=3,
                                       device="cpu")
    bt3, bv3 = create_trajectory_batch(5, "ornstein_uhlenbeck", 0.1, seed=4,
                                       device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(bv, bv2))
    assert not all(torch.equal(a, b) for a, b in zip(bv, bv3))


def test_subsample_random_grid_points_shapes_and_seed():
    times, X = generate_ou(seed=1, device="cpu")
    ts, xs = subsample_random_grid_points(times, X, 0.1, seed=2)
    assert ts.shape == xs.shape == (10,)
    assert float(ts[0]) == 0.0 and float(ts[-1]) == 1.0
    assert torch.all(ts[1:] > ts[:-1])
    ts2, xs2 = subsample_random_grid_points(times, X, 0.1, seed=2)
    assert torch.equal(ts, ts2) and torch.equal(xs, xs2)
    idx = torch.round(ts * 100).long()
    assert torch.equal(xs, X[idx])


@pytest.mark.parametrize("fn,n_out", [
    (generate_black_scholes, 2), (generate_ou, 2), (generate_heston, 3),
    (generate_hybrid_ou_bs, 3)])
def test_generate_helpers_shapes_and_seed(fn, n_out):
    out = fn(seed=7, device="cpu")
    again = fn(seed=7, device="cpu")
    assert len(out) == n_out and out[0].shape == (101,)
    assert out[1].shape == (101,)
    assert torch.equal(out[1], again[1])
    if fn is generate_hybrid_ou_bs:
        assert 0.2 <= out[2] <= 0.8


def test_generators_default_to_the_card(monkeypatch):
    """The port's entry points default to cuda: without a card a seeded
    helper raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_ou(seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_trajectory_batch(2, "heston", seed=0)


# ------------------------------------------------------------ training

FAMILIES = {
    "ornstein_uhlenbeck": (dict(theta=1.0, mu=0.5, sigma=0.3, x0=0.0), True),
    "heston": (dict(mu=0.5, kappa=2.0, theta=0.04, xi=0.5, rho=-0.5, x0=1.0,
                    v0=0.04), False),
    "hybrid_ou_bs": (dict(theta_ou=1.0, mu_ou=0.5, sigma_ou=0.3, mu_bs=0.1,
                          sigma_bs=0.2, x0=1.0), True),
}


def family_config(process, use_pallas="auto", **over):
    params, obs_only = FAMILIES[process]
    cfg = {
        "experiment_name": process, "input_dim": 1, "hidden_dim": 8,
        "output_dim": 1, "n_hidden_layers": 1, "activation": "relu",
        "learning_rate": 1e-3, "weight_decay": 5e-4, "n_epochs": 2,
        "batch_size": 16, "print_every": 1, "device": "cpu",
        "ignore_first_continuity": True, "num_moments": 2,
        "moment_weights": [1.0, 10.0], "use_pallas": use_pallas,
        "seed": 0, "data_seed": 0,
        "data": {"process_type": process, "n_train": 24, "n_val": 8,
                 "obs_fraction": 0.1, "cache_data": False,
                 "obs_only": obs_only, "T": 1.0, "n_steps": 100, **params}}
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("use_pallas", ["auto", "train"])
@pytest.mark.parametrize("process", list(FAMILIES))
def test_run_experiment_trains_every_family(tmp_path, process, use_pallas):
    """Two epochs on the CPU, composed ("auto" off the card) and on the
    whole-run kernel's plain version ("train"); the relative loss of every
    family has truths."""
    res = run_experiment(family_config(process, use_pallas),
                         save_dir=str(tmp_path))
    hist = res["history"]
    assert len(hist["train_loss"]) == 2 and len(hist["relative_loss"]) == 2
    assert np.isfinite(hist["train_loss"] + hist["val_loss"]
                       + hist["relative_loss"]).all()


def test_exact_hybrid_truths_use_the_recorded_switch_times(tmp_path):
    """Random switch times: zero truths without a record (the reference's
    result), the recorded switch times with ``exact_hybrid_truths``; the
    two relative losses differ."""
    from njode_tpu_torch.models import NeuralJumpODE
    from njode_tpu_torch.utils import Trainer, create_data_loaders
    cfg = family_config("hybrid_ou_bs")
    model = NeuralJumpODE(1, 8, 1, num_moments=2, device="cpu")
    trainer = Trainer(model, moment_weights=[1.0, 10.0])
    train_fn, _ = create_data_loaders(device="cpu", **cfg["data"])
    plain = trainer._setup_relative_loss(train_fn, cfg)
    exact = trainer._setup_relative_loss(
        train_fn, dict(cfg, exact_hybrid_truths=True))
    assert torch.all(plain["y_true_before"] == 0)
    assert bool((exact["y_true_before"][:, 1:, :, 0] != 0).any())


def test_heston_extended_moments_refused_before_any_work(tmp_path):
    with pytest.raises(ValueError, match="extended-moments is unsupported"):
        run_experiment(family_config("heston", extended_moments=True,
                                     num_moments=3), save_dir=str(tmp_path))
    assert not (tmp_path / "heston").exists()
