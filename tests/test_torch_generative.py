"""The port's generative sampler held against ``njode_tpu.sample_paths`` on
the CPU.

``sample_paths_from_normals`` is the port's deterministic rollout; fed the
JAX sampler's own normals for its key (step i's draw is
``jax.random.normal(split(key, G)[i], (B, d_y))``) and the JAX model's
weights, it must give the JAX samples: at rtol 1e-5 / atol 1e-6 for the
deterministic ``mean`` law and the first stochastic step, and at rtol 1e-4 /
atol 1e-5 over whole stochastic paths, where each draw feeds the next
step's input and the f32 summation order's differences compound.
``sample_paths`` itself draws from a ``torch.Generator``; it is held by
the normals it draws and by law.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu import sample_paths as jax_sample_paths
from njode_tpu_torch import NeuralJumpODE, sample_paths
from njode_tpu_torch.generative import STEP_LAWS, sample_paths_from_normals
from njode_tpu_torch.ops import gap_scan
from njode_tpu_torch.utils import state_dict_from_jax

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
PATH_TOL = dict(rtol=1e-4, atol=1e-5)
B, G = 6, 11
KW = dict(input_dim=1, hidden_dim=12, output_dim=1, num_moments=2,
          dt_ode_step=0.05, t_max=1.0, activation="tanh")


def bridged(**over):
    kw = dict(KW, **over)
    jax_model = JaxModel(use_pallas=False, **kw)
    params = jax_model.init(jax.random.PRNGKey(0))
    # a mean near 1 and a variance near 1e-2 keep the lognormal law away
    # from its gaussian fallback, as a trained Black-Scholes model would:
    # the readout's biases (mean, then W) set to 1 and 0.1 (direct: Var =
    # W^2) or 1.01 (second_moment: Var = W - mean^2)
    out = params["out"]["layers"][-1]
    w = 0.1 if kw.get("variance_method", "direct") == "direct" else 1.01
    out["b"] = out["b"].at[0].set(1.0).at[1].set(w)
    port = NeuralJumpODE(**kw, device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=kw["num_moments"],
        shared_network=kw.get("shared_network", False), n_hidden_layers=1))
    return jax_model, params, port


def jax_normals(key, n_grid, n_paths, d_y=1):
    """The normals the JAX sampler draws for step i (njode_tpu/generative.py:
    66, 151): its key split G ways."""
    keys = jax.random.split(key, n_grid)
    return np.stack([np.asarray(jax.random.normal(keys[i], (n_paths, d_y),
                                                  jnp.float32))
                     for i in range(n_grid)])


def grid_times(per_path):
    """Strictly increasing times on [0.5, 1.0]; per path, each row shifted
    and unevenly spaced."""
    base = np.linspace(0.5, 1.0, G, dtype=np.float32)
    if not per_path:
        return base
    rng = np.random.default_rng(1)
    steps = rng.uniform(0.02, 0.06, (B, G)).astype(np.float32)
    return (0.4 + np.cumsum(steps, axis=1)).astype(np.float32)


X0 = {"scalar": 1.1, "d_x": np.array([0.9], np.float32),
      "B": np.linspace(0.8, 1.2, B).astype(np.float32),
      "B,d_x": np.linspace(0.8, 1.2, B).astype(np.float32)[:, None]}
PREFIX = (np.array([0.0, 0.15, 0.3, 0.45], np.float32),
          np.array([[1.0], [1.05], [0.97], [1.1]], np.float32))
CASES = {  # case -> (per-path times, x0 shape or None for the prefix)
    "shared-scalar": (False, "scalar"), "shared-d_x": (False, "d_x"),
    "per_path-B": (True, "B"), "per_path-B,d_x": (True, "B,d_x"),
    "shared-prefix": (False, None), "per_path-prefix": (True, None)}


def run_both(law, case, seed=3, **over):
    jax_model, params, port = bridged(**over)
    per_path, x0_kind = CASES[case]
    t = grid_times(per_path)
    x0 = X0[x0_kind] if x0_kind else None
    obs_t, obs_v = PREFIX if x0_kind is None else (None, None)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_sample_paths(
        jax_model, params, key, B, jnp.asarray(t),
        None if x0 is None else jnp.asarray(x0), law=law,
        obs_times=None if obs_t is None else jnp.asarray(obs_t),
        obs_values=None if obs_v is None else jnp.asarray(obs_v)))
    normals = (None if law == "mean"
               else torch.as_tensor(jax_normals(key, G, B)))
    ours = sample_paths_from_normals(port, normals, B, t, x0, law, obs_t,
                                     obs_v).numpy()
    return ours, ref, x0_kind is None


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("law", STEP_LAWS)
def test_sample_paths_from_normals_matches_jax(law, case):
    ours, ref, prefix = run_both(law, case)
    assert ours.shape == ref.shape == (B, G, 1)
    assert np.isfinite(ours).all()
    if law == "mean":
        np.testing.assert_allclose(ours, ref, **STEP_TOL)
        return
    first = 0 if prefix else 1            # the first stochastic step
    np.testing.assert_allclose(ours[:, :first + 1], ref[:, :first + 1],
                               **STEP_TOL)
    np.testing.assert_allclose(ours, ref, **PATH_TOL)


@pytest.mark.parametrize("law", ["gaussian", "lognormal"])
def test_shared_network_and_second_moment(law):
    ours, ref, _ = run_both(law, "shared-scalar", seed=5,
                            variance_method="second_moment",
                            shared_network=True)
    np.testing.assert_allclose(ours[:, :2], ref[:, :2], **STEP_TOL)
    np.testing.assert_allclose(ours, ref, **PATH_TOL)


def test_lognormal_falls_back_to_the_gaussian_draw_where_the_mean_is_not_positive():
    """A model whose mean reads below 0 everywhere: the lognormal draw is
    the gaussian one, as in the JAX package."""
    jax_model, params, port = bridged()
    for p in (port.output_nns[0].net[-1].bias,):
        p.data.fill_(-1.0)
    t = grid_times(False)
    normals = torch.as_tensor(jax_normals(jax.random.PRNGKey(0), G, B))
    logn = sample_paths_from_normals(port, normals, B, t, 1.0, "lognormal")
    gauss = sample_paths_from_normals(port, normals, B, t, 1.0, "gaussian")
    assert (logn[:, 1:] < 0).any()
    torch.testing.assert_close(logn, gauss, rtol=0, atol=0)


def jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_errors_keep_the_jax_wording():
    jax_model, params, port = bridged()
    one = dict(KW, num_moments=1)
    jax1 = JaxModel(use_pallas=False, **one)
    port1 = NeuralJumpODE(**one, device="cpu")
    key, t = jax.random.PRNGKey(0), grid_times(False)
    per_path = np.tile(t, (B + 1, 1))
    gen = torch.Generator().manual_seed(0)
    cases = [
        (lambda: jax_sample_paths(jax_model, params, key, B, t, 1.0,
                                  law="cauchy"),
         lambda: sample_paths(port, gen, B, t, 1.0, law="cauchy")),
        (lambda: jax_sample_paths(jax1, jax1.init(key), key, B, t, 1.0,
                                  law="gaussian"),
         lambda: sample_paths(port1, gen, B, t, 1.0, law="gaussian")),
        (lambda: jax_sample_paths(jax_model, params, key, B, per_path, 1.0),
         lambda: sample_paths(port, gen, B, per_path, 1.0))]
    for jax_call, port_call in cases:
        want = jax_error(jax_call)
        with pytest.raises(ValueError, match=re.escape(want)):
            port_call()
    # a one-moment model samples its mean
    out = sample_paths(port1, gen, B, t, 1.0, law="mean")
    assert out.shape == (B, G, 1) and torch.isfinite(out).all()


def test_gap_budget_is_checked_before_the_first_step():
    _, _, port = bridged(t_max=0.2)
    t = np.array([0.0, 0.1, 0.6], np.float32)
    with pytest.raises(ValueError, match="substep budget"):
        sample_paths(port, torch.Generator().manual_seed(0), B, t, 1.0)


def test_sample_paths_draws_its_normals_first_and_repeats_bitwise():
    """sample_paths = sample_paths_from_normals on the (G, B, d_y) normals
    its generator gives first; one seed, one result; the gap kernel's plain
    version runs on the CPU and no kernel launches."""
    _, _, port = bridged()
    t = grid_times(False)
    gap_scan.LAUNCHES = 0
    a = sample_paths(port, torch.Generator().manual_seed(9), B, t, 1.0)
    b = sample_paths(port, torch.Generator().manual_seed(9), B, t, 1.0)
    normals = torch.randn(G, B, 1, generator=torch.Generator().manual_seed(9))
    c = sample_paths_from_normals(port, normals, B, t, 1.0)
    assert gap_scan.LAUNCHES == 0
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, sample_paths(
        port, torch.Generator().manual_seed(10), B, t, 1.0))


@pytest.mark.parametrize("law", ["gaussian", "lognormal"])
def test_one_step_draws_follow_the_models_moments(law):
    """By law: 20,000 one-step draws from one x0 have the model's
    predicted mean and variance within 5 standard errors."""
    _, _, port = bridged()
    n = 20_000
    t = np.array([0.5, 0.6], np.float32)
    s = sample_paths(port, torch.Generator().manual_seed(1), n, t, 1.0,
                     law=law)[:, 1, 0].double()
    pred = port.predict_at(torch.tensor([[0.5]]), torch.tensor([[[1.0]]]),
                           torch.tensor([[0.6]]))
    m, v = float(pred["mean"]), float(pred["var"])
    assert abs(float(s.mean()) - m) < 5 * (v / n) ** 0.5
    # the variance of a sample variance: (mu4 - v^2) / n, with mu4 from the
    # draws themselves
    mu4 = float(((s - s.mean()) ** 4).mean())
    assert abs(float(s.var()) - v) < 5 * ((mu4 - v * v) / n) ** 0.5
