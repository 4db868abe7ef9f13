"""The port's whole-gap integration (njode_tpu_torch/ops/gap_scan.py) held
against the JAX package on the CPU.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py``.  The JAX side runs the Pallas kernel in interpret mode
and the model's XLA loop.  Inputs come from numpy with a fixed seed.

Tolerances: h to rtol = atol = 1e-5, the f32 summation order of the split
feature matmul compounded over the substeps (njode_tpu/ops/gap_scan.py:48-50);
t_L bitwise, since both sides accumulate t by the same single f32 adds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.ops import gap_scan_available as jax_available
from njode_tpu.ops import integrate_gap_fused as jax_integrate
from njode_tpu.ops.fused_cell import _round_up
from njode_tpu.ops.gap_scan import LANES, _gap_scan, _pad_rows, _row_tile
from njode_tpu_torch.ops import gap_scan

ACTS = ("relu", "tanh", "sigmoid", "elu", "leaky_relu", "selu")
SCALES = ("identity", "tanh", "sigmoid")
TOL = dict(rtol=1e-5, atol=1e-5)


def make_case(seed, K, R, d_h, d_x=1, dt=0.03, n_sub=8):
    """Gaps of every kind: zero, shorter than dt, ending on a grid point
    (t0 and t1 multiples of dt), and free up to the substep budget."""
    rng = np.random.default_rng(seed)
    d_in = d_h + d_x + 2
    f32 = np.float32
    t0 = rng.uniform(0.0, 0.2, R).astype(f32)
    t1 = t0 + rng.uniform(0.0, dt * (n_sub + 1), R).astype(f32)
    t1[0] = t0[0]                                    # zero gap
    if R > 1:
        t1[1] = t0[1] + f32(0.4 * dt)                # partial step only
    if R > 2:
        t0[2], t1[2] = f32(3 * dt), f32(7 * dt)      # on the grid
    return {
        "h": (rng.normal(size=(K, R, d_h)) * 0.5).astype(f32),
        "x": rng.normal(size=(R, d_x)).astype(f32),
        "t0": t0, "t1": t1,
        "w1": (rng.normal(size=(K, d_in, d_h)) * 0.3).astype(f32),
        "b1": (rng.normal(size=(K, d_h)) * 0.1).astype(f32),
        "w2": (rng.normal(size=(K, d_h, d_h)) * 0.3).astype(f32),
        "b2": (rng.normal(size=(K, d_h)) * 0.1).astype(f32),
        "dt": dt, "n_sub": n_sub,
    }


def jax_layers(c):
    return [{"w": jnp.asarray(c["w1"]), "b": jnp.asarray(c["b1"])},
            {"w": jnp.asarray(c["w2"]), "b": jnp.asarray(c["b2"])}]


def torch_weights(c):
    """(W1, b1, W2, b2) in torch's (out, in) orientation, stacked on K."""
    t = torch.from_numpy
    return (t(np.swapaxes(c["w1"], 1, 2).copy()), t(c["b1"]),
            t(np.swapaxes(c["w2"], 1, 2).copy()), t(c["b2"]))


def port_integrate(c, act, scale, fn=gap_scan.integrate_gap_reference,
                   n_sub=None):
    t = torch.tensor
    h, _ = fn(t(c["h"]), t(c["x"]), t(c["t0"]), t(c["t1"]),
              gap_scan.split_weights(torch_weights(c)), c["dt"],
              c["n_sub"] if n_sub is None else n_sub, act, scale)
    return h.numpy()


def jax_kernel(c, act, scale, n_sub=None):
    out = jax_integrate(jnp.asarray(c["h"]), jnp.asarray(c["x"]),
                        jnp.asarray(c["t0"]), jnp.asarray(c["t1"]),
                        jax_layers(c), c["dt"],
                        c["n_sub"] if n_sub is None else n_sub, act, scale,
                        interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("K", [1, 2], ids=["shared", "separate"])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_jax_kernel(act, scale, K):
    c = make_case(ACTS.index(act) * 10 + SCALES.index(scale) + K, K, 13, 12)
    np.testing.assert_allclose(port_integrate(c, act, scale),
                               jax_kernel(c, act, scale), **TOL)


@pytest.mark.parametrize("dt,n_sub", [(0.01, 20), (0.03, 8), (0.1, 3),
                                      (1.0 / 3.0, 4)])
def test_t_last_bitwise_vs_jax_kernel(dt, n_sub):
    """t_L of the full-step loop equals the JAX kernel's bit for bit."""
    c = make_case(7, 1, 40, 4, dt=dt, n_sub=n_sub)
    R, d_h = 40, 4
    dh_p = _round_up(d_h + 1, LANES)
    r_p = _round_up(R, _row_tile(R, dh_p))
    col = lambda v: _pad_rows(jnp.asarray(v)[:, None], r_p)
    zeros = jnp.zeros((r_p, dh_p), jnp.float32)
    w = jnp.zeros((dh_p, dh_p), jnp.float32)
    v = jnp.zeros((1, dh_p), jnp.float32)
    _, t_jax = _gap_scan(zeros, col(c["t0"]), col(c["t1"]), zeros, w, v, w,
                         v, d_h, dt, n_sub, "relu", "identity", True)
    t = torch.from_numpy
    _, t_port = gap_scan.gap_substeps_reference(
        t(c["h"]), t(c["h"]), t(c["t0"]), t(c["t1"]),
        torch.zeros(1, d_h, d_h), torch.zeros(1, d_h),
        torch.zeros(1, d_h, d_h), torch.zeros(1, d_h), dt, n_sub, "relu",
        "identity")
    np.testing.assert_array_equal(t_port.numpy(), np.asarray(t_jax)[:R, 0])
    assert np.any(t_port.numpy() > c["t0"])  # the loop did move


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "separate"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_jax_xla_loop(act, shared):
    """Against the JAX model's non-kernel loop, whose full steps use
    t_elapsed = t_new - t_cur instead of the constant dt."""
    scale = SCALES[ACTS.index(act) % 3]
    K = 1 if shared else 2
    c = make_case(100 + ACTS.index(act), K, 11, 10)
    model = JaxModel(input_dim=1, hidden_dim=10, output_dim=1, num_moments=2,
                     activation=act, input_scaling=scale,
                     shared_network=shared, dt_ode_step=c["dt"],
                     max_substeps=c["n_sub"], use_pallas=False)
    layers = jax_layers(c)
    if shared:
        layers = [{"w": l["w"][0], "b": l["b"][0]} for l in layers]
    ref = model._integrate_gap({"ode": {"layers": layers}},
                               jnp.asarray(c["h"]), jnp.asarray(c["x"]),
                               jnp.asarray(c["t0"]), jnp.asarray(c["t1"]))
    x_scaled = np.asarray(model._scale(jnp.asarray(c["x"])))
    np.testing.assert_allclose(
        port_integrate(dict(c, x=x_scaled), act, scale), np.asarray(ref),
        **TOL)


@pytest.mark.parametrize("d_h", [1, 127, 128])
def test_hidden_widths_around_the_lane_padding(d_h):
    """d_h = 127 fills the JAX kernel's 128 lanes with the spare t lane;
    d_h = 128 forces its widening to 256; the port has no padding."""
    c = make_case(d_h, 2, 9, d_h)
    np.testing.assert_allclose(port_integrate(c, "tanh", "identity"),
                               jax_kernel(c, "tanh", "identity"), **TOL)


def test_zero_gaps_and_zero_budget():
    c = make_case(5, 2, 10, 6, dt=0.5, n_sub=3)
    out = port_integrate(c, "relu", "tanh")
    np.testing.assert_array_equal(out[:, 0], c["h"][:, 0])  # zero gap inert
    # max_substeps=0: only the final partial step applies
    c0 = dict(c, t1=(c["t0"] + np.linspace(0, 0.45, 10)).astype(np.float32))
    np.testing.assert_allclose(port_integrate(c0, "relu", "tanh", n_sub=0),
                               jax_kernel(c0, "relu", "tanh", n_sub=0), **TOL)
    model = JaxModel(input_dim=1, hidden_dim=6, output_dim=1, num_moments=2,
                     activation="relu", input_scaling="tanh",
                     dt_ode_step=0.5, max_substeps=0, use_pallas=False)
    ref = model._integrate_gap({"ode": {"layers": jax_layers(c0)}},
                               jnp.asarray(c0["h"]), jnp.asarray(c0["x"]),
                               jnp.asarray(c0["t0"]), jnp.asarray(c0["t1"]))
    x_scaled = np.tanh(c0["x"])
    np.testing.assert_allclose(
        port_integrate(dict(c0, x=x_scaled), "relu", "tanh", n_sub=0),
        np.asarray(ref), **TOL)


def test_whole_gap_returns_the_loops_t_last():
    """integrate_gap_* return the full steps' t_L with h: the loop's own."""
    c = make_case(13, 2, 9, 5)
    t = torch.tensor
    w = gap_scan.split_weights(torch_weights(c))
    args = gap_scan.substep_inputs(t(c["h"]), t(c["x"]), t(c["t0"]),
                                   t(c["t1"]), w, c["dt"])
    _, t_loop = gap_scan.gap_substeps_reference(*args, c["dt"], c["n_sub"],
                                                "relu", "identity")
    _, t_gap = gap_scan.integrate_gap_reference(
        t(c["h"]), t(c["x"]), t(c["t0"]), t(c["t1"]), w, c["dt"],
        c["n_sub"], "relu", "identity")
    assert torch.equal(t_gap, t_loop)
    assert torch.all(t(c["t1"]) - t_gap <= c["dt"])


def test_cpu_wrapper_takes_the_plain_version():
    c = make_case(11, 2, 7, 5)
    gap_scan.LAUNCHES = 0
    fused = port_integrate(c, "elu", "sigmoid", fn=gap_scan.integrate_gap_fused)
    np.testing.assert_array_equal(fused, port_integrate(c, "elu", "sigmoid"))
    assert gap_scan.LAUNCHES == 0


def test_wrapper_refuses_gradients_and_foreign_devices():
    """A gradient no longer raises: it goes through GapScan, the training
    pair (its plain versions on the CPU), and equals plain autograd; a
    foreign device still raises."""
    c = make_case(12, 1, 4, 3)
    t = torch.from_numpy
    w1, b1, w2, b2 = torch_weights(c)
    w1.requires_grad_(True)
    grads = []
    for fn in (gap_scan.integrate_gap_fused, gap_scan.integrate_gap_reference):
        out, _ = fn(t(c["h"]), t(c["x"]), t(c["t0"]), t(c["t1"]),
                    gap_scan.split_weights((w1, b1, w2, b2)), 0.03, 8,
                    "relu", "identity")
        grads.append(torch.autograd.grad(out.sum(), w1)[0])
    assert grads[0].abs().sum() > 0
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-5, atol=1e-6)
    meta = [x.to("meta") for x in (t(c["h"]), t(c["x"]), t(c["t0"]),
                                   t(c["t1"]))]
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        gap_scan.integrate_gap_fused(
            *meta, gap_scan.split_weights(
                tuple(x.to("meta") for x in torch_weights(c))), 0.03, 8,
            "relu", "identity")


@pytest.mark.parametrize("cfg", [
    (1, "relu", 0.0, "identity"), (1, "tanh", 0.0, "tanh"),
    (2, "relu", 0.0, "identity"), (1, "selu", 0.0, "sigmoid"),
    (1, "gelu", 0.0, "identity"), (1, "relu", 0.1, "identity"),
    (1, "relu", 0.0, "softplus")])
def test_eligibility_gate_matches_jax(cfg):
    assert gap_scan.gap_scan_available(*cfg) == jax_available(*cfg)
