"""The fused Euler cell's port (njode_tpu_torch/ops/fused_cell.py, row 6)
held against the JAX package's ``njode_tpu/ops/fused_cell.py`` on the CPU.

On the CPU :class:`FusedEulerCell` runs the kernel's plain version; the
CUDA kernel is held against it on the card by ``chip_smoke.py``.  The JAX
side runs its Pallas kernel in interpret mode.  Inputs from numpy with a
fixed seed.  Tolerances: values rtol = atol = 1e-5 and gradients rtol 1e-4
/ atol 1e-5 (f32 sums in another order; a step of up to 0.4 in time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.ops import fused_cell_available as jax_available
from njode_tpu.ops import ode_euler_fused as jax_cell
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.ops import fused_cell
from njode_tpu_torch.utils import state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SCALES = {"identity": (lambda v: v, lambda v: v),
          "tanh": (jnp.tanh, torch.tanh),
          "sigmoid": (jax.nn.sigmoid, torch.sigmoid)}


def make_case(seed, K, B, d_h, d_x=1):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t_cur = rng.uniform(0.0, 0.6, B).astype(f32)
    t_new = t_cur + rng.uniform(0.0, 0.4, B).astype(f32)
    t_new[0] = t_cur[0]                               # a zero step
    d_in = d_h + d_x + 2
    return {"h": (rng.normal(size=(K, B, d_h)) * 0.5).astype(f32),
            "x": rng.normal(size=(B, d_x)).astype(f32),
            "t_cur": t_cur, "t_new": t_new,
            "w1": (rng.normal(size=(K, d_in, d_h)) * 0.3).astype(f32),
            "b1": (rng.normal(size=(K, d_h)) * 0.1).astype(f32),
            "w2": (rng.normal(size=(K, d_h, d_h)) * 0.3).astype(f32),
            "b2": (rng.normal(size=(K, d_h)) * 0.1).astype(f32),
            "ct": rng.normal(size=(K, B, d_h)).astype(f32)}


def jax_step(c, act, scale):
    """The JAX cell's step (interpret mode) and the cotangents of h, x and
    W1, b1, W2, b2 ((in, out))."""
    sc = SCALES[scale][0]

    def f(h, x, w1, b1, w2, b2):
        return jax_cell(h, sc(x), sc(h), jnp.asarray(c["t_cur"]),
                        jnp.asarray(c["t_new"]),
                        [{"w": w1, "b": b1}, {"w": w2, "b": b2}], act,
                        interpret=True)
    args = [jnp.asarray(c[k]) for k in ("h", "x", "w1", "b1", "w2", "b2")]
    out, vjp = jax.vjp(f, *args)
    return [np.asarray(out)] + [np.asarray(g) for g in
                                vjp(jnp.asarray(c["ct"]))]


def port_step(c, act, scale, fn=fused_cell.ode_euler_fused):
    sc = SCALES[scale][1]
    t = torch.from_numpy
    h, x = t(c["h"]).requires_grad_(), t(c["x"]).requires_grad_()
    raw = [t(np.swapaxes(c["w1"], 1, 2).copy()).requires_grad_(),
           t(c["b1"]).requires_grad_(),
           t(np.swapaxes(c["w2"], 1, 2).copy()).requires_grad_(),
           t(c["b2"]).requires_grad_()]
    out = fn(h, sc(x), sc(h), t(c["t_cur"]), t(c["t_new"]), raw, act)
    g = torch.autograd.grad(out, [h, x, *raw], t(c["ct"]))
    return [out.detach().numpy(), g[0].numpy(), g[1].numpy(),
            g[2].transpose(1, 2).numpy(), g[3].numpy(),
            g[4].transpose(1, 2).numpy(), g[5].numpy()]


@pytest.mark.parametrize("K", [1, 2], ids=["shared", "separate"])
@pytest.mark.parametrize("act,scale", [
    ("relu", "identity"), ("tanh", "tanh"), ("sigmoid", "identity"),
    ("elu", "sigmoid"), ("leaky_relu", "tanh"), ("selu", "identity")])
def test_ode_euler_fused_matches_jax(act, scale, K):
    c = make_case(K * 10 + len(act), K, 13, 7)
    ours, ref = port_step(c, act, scale), jax_step(c, act, scale)
    np.testing.assert_allclose(ours[0], ref[0], **TOL)
    for name, a, b in zip(("h", "x", "W1", "b1", "W2", "b2"), ours[1:],
                          ref[1:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("act", ["relu", "tanh", "selu"])
def test_backward_matches_plain_autograd(act):
    """FusedEulerCell's backward (``_bwd``'s algebra) equals autograd
    through the plain step, in f64 to roundoff; the time step gets its
    cotangent too."""
    c = make_case(3, 2, 9, 5)
    c64 = {k: v.astype(np.float64) for k, v in c.items()}
    for a, b in zip(port_step(c64, act, "tanh"),
                    port_step(c64, act, "tanh",
                              fused_cell.ode_euler_reference)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    t = torch.from_numpy
    args = list(fused_cell._cell_inputs(
        t(c64["h"]), t(c64["x"]), t(c64["h"]), t(c64["t_cur"]),
        t(c64["t_new"]), [t(np.swapaxes(c64["w1"], 1, 2).copy()),
                          t(c64["b1"]), t(np.swapaxes(c64["w2"], 1, 2).copy()),
                          t(c64["b2"])]))
    inp, dt, w1, b1, w2, b2 = [x.detach().requires_grad_() for x in args]
    h = t(c64["h"]).requires_grad_()
    ins = [inp, h, dt, w1, b1, w2, b2]
    ours = torch.autograd.grad(
        fused_cell.FusedEulerCell.apply(*ins, act), ins, t(c64["ct"]))
    ref = torch.autograd.grad(
        fused_cell.fused_cell_reference(*ins, act)[0], ins, t(c64["ct"]))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_cpu_wrapper_takes_the_plain_version_and_refuses_other_devices():
    c = make_case(4, 2, 6, 4)
    fused_cell.LAUNCHES = 0
    np.testing.assert_array_equal(
        port_step(c, "relu", "identity")[0],
        port_step(c, "relu", "identity", fused_cell.ode_euler_reference)[0])
    assert fused_cell.LAUNCHES == 0
    t = torch.from_numpy
    meta = [t(c[k]).to("meta") for k in ("h", "x", "t_cur", "t_new")]
    w = [t(np.swapaxes(c["w1"], 1, 2).copy()).to("meta"),
         t(c["b1"]).to("meta"), t(np.swapaxes(c["w2"], 1, 2).copy()).to(
             "meta"), t(c["b2"]).to("meta")]
    with pytest.raises(ValueError, match="no kernel"):
        fused_cell.ode_euler_fused(meta[0], meta[1], meta[0], meta[2],
                                   meta[3], w, "relu")


@pytest.mark.parametrize("cfg", [
    (1, "relu", 0.0), (1, "tanh", 0.0), (2, "relu", 0.0), (1, "gelu", 0.0),
    (1, "relu", 0.1), (1, "selu", 0.0)])
def test_eligibility_gate_matches_jax(cfg):
    assert fused_cell.fused_cell_available(*cfg) == jax_available(*cfg)


def test_forced_model_serves_through_the_cell():
    """predict_at of a model without dt_ode_step under use_pallas=True: one
    cell step a query, against the JAX model under "interpret"."""
    kw = dict(input_dim=1, hidden_dim=10, output_dim=1, num_moments=2,
              shared_network=False, activation="elu", input_scaling="tanh")
    jax_model = JaxModel(use_pallas="interpret", **kw)
    params = jax_model.init(jax.random.PRNGKey(2))
    port = NeuralJumpODE(**kw, use_pallas=True, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, num_moments=2,
                                             shared_network=False,
                                             n_hidden_layers=1))
    assert port._use_fused() and not NeuralJumpODE(
        **kw, device="cpu")._use_fused()
    rng = np.random.default_rng(5)
    times = np.sort(rng.uniform(0.0, 1.0, (4, 5)), axis=1).astype(np.float32)
    values = np.exp(rng.normal(size=(4, 5, 1)) * 0.3).astype(np.float32)
    query = np.sort(rng.uniform(0.0, 1.0, (4, 3)), axis=1).astype(np.float32)
    ours = port.predict_at(times, values, query)["raw"].numpy()
    ref = np.asarray(jax_model.predict_at(params, jnp.asarray(times),
                                          jnp.asarray(values),
                                          jnp.asarray(query))["raw"])
    np.testing.assert_allclose(ours, ref, **TOL)
