"""The port's serving path (predict_at, NJODEFilter) held against the JAX
package on the CPU, with the JAX model's weights carried across.

The JAX side runs both its XLA loop (``use_pallas=False``) and its gap
kernel in interpret mode; the port runs the kernel's plain version, as it
does for every CPU tensor.  Outputs agree to rtol = atol = 1e-5: the f32
summation order over up to 100 compounded substeps, and the kernel's
constant-dt t_elapsed feature against the XLA loop's t_new - t_cur.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.models import pad_ragged as jax_pad_ragged
from njode_tpu.serving import NJODEFilter as JaxFilter
from njode_tpu_torch import NeuralJumpODE, NJODEFilter
from njode_tpu_torch.models import pad_ragged
from njode_tpu_torch.ops import gap_scan
from njode_tpu_torch.utils import state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
PRODUCTION = dict(input_dim=1, hidden_dim=50, output_dim=1, num_moments=2,
                  n_hidden_layers=1, activation="relu",
                  input_scaling="identity", shared_network=True,
                  dt_ode_step=0.01, t_max=1.0)
SEPARATE = dict(PRODUCTION, hidden_dim=16, shared_network=False,
                activation="tanh", input_scaling="tanh")


def bridged(use_pallas=False, seed=0, **kw):
    jax_model = JaxModel(use_pallas=use_pallas, **kw)
    params = jax_model.init(jax.random.PRNGKey(seed))
    port = NeuralJumpODE(**kw, device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=kw["num_moments"],
        shared_network=kw["shared_network"],
        n_hidden_layers=kw.get("n_hidden_layers", 1)))
    return jax_model, params, port


def ragged_request(seed=0, B=6, Q=5, d_x=1):
    """Sorted observation times on [0, 1] with ragged lengths (end-padded),
    some streams starting after 0, and queries on [-0.1, 1]."""
    rng = np.random.default_rng(seed)
    times, values = [], []
    for b in range(B):
        n = int(rng.integers(2, 7))
        t = np.sort(rng.uniform(0.0, 1.0, n)).astype(np.float32)
        if b % 2 == 0:
            t[0] = 0.0
        times.append(t)
        values.append(np.exp(rng.normal(size=(n, d_x)) * 0.3).astype(
            np.float32))
    query = np.sort(rng.uniform(-0.1, 1.0, (B, Q)), axis=1).astype(np.float32)
    return times, values, query


def jax_predict(jax_model, params, times, values, query):
    t, v, m = jax_pad_ragged(times, values)
    return jax_model.predict_at(params, t, v, jnp.asarray(query), m)


def test_pad_ragged_matches_jax():
    times, values, _ = ragged_request(1)
    ours = pad_ragged(times, values)
    for a, b in zip(ours, jax_pad_ragged(times, values)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("jax_pallas", [False, "interpret"])
@pytest.mark.parametrize("cfg", [PRODUCTION, SEPARATE],
                         ids=["production", "separate"])
def test_predict_at_matches_jax(cfg, jax_pallas):
    jax_model, params, port = bridged(jax_pallas, **cfg)
    times, values, query = ragged_request(2)
    ref = jax_predict(jax_model, params, times, values, query)
    gap_scan.LAUNCHES = 0
    out = port.predict_at(*pad_ragged(times, values)[:2], query,
                          pad_ragged(times, values)[2])
    assert gap_scan.LAUNCHES == 0          # CPU tensors: the plain version
    for key in ("raw", "mean", "var"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   **TOL)
    # queries before the first observation read exactly 0
    first = np.array([t[0] for t in times])[:, None]
    before = query < first
    assert before.any()
    assert np.all(out["raw"].numpy()[before] == 0.0)


@pytest.mark.parametrize("cfg,kernel", [
    (dict(SEPARATE, ode_solver="heun"), False),
    (dict(SEPARATE, ode_solver="rk4", shared_network=True), False),
    (dict(SEPARATE, n_hidden_layers=2), False),
    (dict(SEPARATE, dropout_rate=0.2), False),
    (dict(SEPARATE, dt_ode_step=None), False),
    (dict(SEPARATE, variance_method="second_moment", activation="identity"),
     True),
    (dict(PRODUCTION, input_dim=2, output_dim=3, hidden_dim=8), True),
    (dict(SEPARATE, input_dim=2, output_dim=3, activation="elu"), True),
], ids=["heun", "rk4", "two-layer", "dropout", "one-step", "second-moment",
        "multidim-shared", "multidim-separate"])
def test_predict_at_configs_match_jax(cfg, kernel):
    """Configurations the kernel does not take run the plain substep loop,
    where the JAX package runs XLA; dropout is off in serving.  The
    'identity' activation is the reference's silent ReLU fallback, which
    the kernel computes."""
    jax_model, params, port = bridged(False, seed=3, **cfg)
    uses_kernel = port._gap_eligible and cfg["dt_ode_step"] is not None
    assert uses_kernel == kernel
    times, values, query = ragged_request(4, d_x=cfg["input_dim"])
    ref = jax_predict(jax_model, params, times, values, query)
    out = port.predict_at(*pad_ragged(times, values)[:2], query,
                          pad_ragged(times, values)[2])
    for key in ("raw", "var"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   **TOL)
    assert port.training  # serving restores the module's mode


def test_gap_budget_error_matches_jax():
    cfg = dict(PRODUCTION, hidden_dim=8, t_max=0.3)
    jax_model, params, port = bridged(False, **cfg)
    t = np.array([[0.0, 0.1]], np.float32)
    v = np.ones((1, 2, 1), np.float32)
    q = np.array([[0.2, 0.9]], np.float32)        # a 0.8 gap > 0.31 budget
    with pytest.raises(ValueError, match="substep budget"):
        jax_model.predict_at(params, jnp.asarray(t), jnp.asarray(v),
                             jnp.asarray(q))
    with pytest.raises(ValueError, match="substep budget"):
        port.predict_at(t, v, q)
    port_dbg = NeuralJumpODE(**dict(cfg, max_substeps=3), debug_checks=True,
                             device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="budget exhausted"):
        port_dbg._integrate_gap(torch.zeros(1, 1, 8), torch.ones(1, 1),
                                torch.zeros(1), torch.full((1,), 0.2),
                                inference=True)


@pytest.mark.parametrize("cfg", [dict(PRODUCTION, hidden_dim=8),
                                 dict(SEPARATE, ode_solver="heun")],
                         ids=["kernel", "plain-loop"])
def test_debug_checks_cover_both_paths(cfg):
    """debug_checks neither changes the route nor the result; the deficit
    check reads t_L from the kernel's wrapper and from the plain loop."""
    _, _, port = bridged(False, **cfg)
    port_dbg = NeuralJumpODE(**cfg, debug_checks=True, device="cpu")
    port_dbg.load_state_dict(port.state_dict())
    times, values, query = ragged_request(5)
    args = (*pad_ragged(times, values)[:2], query, pad_ragged(times, values)[2])
    torch.testing.assert_close(port_dbg.predict_at(*args)["raw"],
                               port.predict_at(*args)["raw"], rtol=0, atol=0)
    short = NeuralJumpODE(**dict(cfg, max_substeps=3), debug_checks=True,
                          device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="budget exhausted"):
        short._integrate_gap(torch.zeros(short.k_hidden, 1, cfg["hidden_dim"]),
                             torch.ones(1, 1), torch.zeros(1),
                             torch.full((1,), 0.2), inference=True)


def test_kernel_weights_follow_the_parameters():
    """The cut kernel weights are rebuilt after load_state_dict."""
    _, _, port = bridged(False, **dict(PRODUCTION, hidden_dim=8))
    times, values, query = ragged_request(7)
    args = (*pad_ragged(times, values)[:2], query, pad_ragged(times, values)[2])
    before = port.predict_at(*args)["raw"]
    assert port.predict_at(*args)["raw"].equal(before)
    _, _, other = bridged(False, seed=1, **dict(PRODUCTION, hidden_dim=8))
    port.load_state_dict(other.state_dict())
    after = port.predict_at(*args)["raw"]
    assert not after.equal(before)
    torch.testing.assert_close(after, other.predict_at(*args)["raw"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [dict(PRODUCTION, hidden_dim=12), SEPARATE],
                         ids=["shared", "separate"])
def test_filter_sequence_matches_jax(cfg):
    """update/predict ticks with masked updates; unseen streams read 0."""
    jax_model, params, port = bridged("interpret", **cfg)
    jf, pf = JaxFilter(jax_model, params), NJODEFilter(port)
    js, ps = jf.init_state(5), pf.init_state(5)
    rng = np.random.default_rng(6)
    t = np.zeros(5, np.float32)
    for i in range(6):
        t = (t + rng.uniform(0.01, 0.15, 5)).astype(np.float32)
        x = np.exp(rng.normal(size=(5, 1)) * 0.2).astype(np.float32)
        mask = None if i % 2 else rng.uniform(size=5) < 0.6
        mask_j = None if mask is None else jnp.asarray(mask)
        js = jf.update(js, jnp.asarray(t), jnp.asarray(x), mask_j)
        ps = pf.update(ps, t, x, mask)
        tq = (t + rng.uniform(0.0, 0.3, 5)).astype(np.float32)
        ref, out = jf.predict(js, jnp.asarray(tq)), pf.predict(ps, tq)
        np.testing.assert_allclose(out["raw"].numpy(), np.asarray(ref["raw"]),
                                   **TOL)
        np.testing.assert_array_equal(ps.seen.numpy(), np.asarray(js.seen))
        assert np.all(out["raw"].numpy()[~ps.seen.numpy()] == 0.0)


def test_filter_unseen_streams_read_zero():
    _, _, port = bridged(False, **SEPARATE)
    f = NJODEFilter(port)
    state = f.init_state(3)
    assert np.all(f.predict(state, 0.5)["raw"].numpy() == 0.0)
    state = f.update(state, 0.1, np.ones((3, 1), np.float32),
                     obs_mask=np.array([True, False, False]))
    raw = f.predict(state, 0.5)["raw"].numpy()
    assert np.any(raw[0] != 0.0) and np.all(raw[1:] == 0.0)


@pytest.mark.parametrize("kw,match", [
    (dict(grid_walk=True), "grid walk"),
    (dict(compute_dtype="bfloat16"), "mixed precision"),
    (dict(use_pallas="step"), "fused training-step"),
    (dict(use_pallas=True), "fused Euler cell"),
    (dict(use_pallas="interpret"), "fused Euler cell"),
])
def test_unported_paths_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        NeuralJumpODE(**PRODUCTION, **kw, device="cpu")
