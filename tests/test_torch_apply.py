"""The port's training forward (``NeuralJumpODE.apply``, ``apply_loss``,
``forward``) held against the JAX package's on the CPU.

JAX weights come into the port through ``state_dict_from_jax``; inputs come
from numpy with a fixed seed.  Tolerances:

* predictions rtol = atol = 1e-5: f32 matmuls summed in another order,
  compounded over the substeps of a gap;
* loss rtol 1e-5, parameter gradients rtol 1e-4 / atol 1e-6: the backward
  adds the per-slot contributions of every weight in another order;
* ``apply`` under ``torch.no_grad()`` with ``dt_ode_step`` takes the gap
  kernel's plain version, whose full steps use the constant dt as the
  t_elapsed feature where the JAX loop uses t_new - t_cur: the two differ by
  rounding (ROADMAP Queue 3, "Time features"), within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.utils import state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
H, N, B = 12, 5, 7

CONFIGS = {
    "separate-single-step": dict(shared_network=False),
    "separate-tanh-scaled": dict(shared_network=False, activation="tanh",
                                 input_scaling="tanh"),
    "shared-dt": dict(shared_network=True, dt_ode_step=0.1),
    "separate-dt": dict(shared_network=False, dt_ode_step=0.1,
                        activation="selu"),
    "shared-heun": dict(shared_network=True, dt_ode_step=0.1,
                        ode_solver="heun"),
    "separate-rk4": dict(shared_network=False, dt_ode_step=0.1,
                         ode_solver="rk4", activation="elu"),
    "shared-mean-only": dict(shared_network=True, num_moments=1),
}


def bridged(seed=0, **cfg):
    kw = dict(input_dim=1, hidden_dim=H, output_dim=1, num_moments=2,
              t_max=1.0)
    kw.update(cfg)
    jax_model = JaxModel(use_pallas=False, **kw)
    params = jax_model.init(jax.random.PRNGKey(seed))
    port = NeuralJumpODE(**kw, device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=kw["num_moments"],
        shared_network=kw["shared_network"], n_hidden_layers=1))
    return jax_model, params, port


def batch(seed=0, padded=True):
    """B trajectories on [0, 1], sorted, slot 0 at t = 0; with ``padded``
    two rows end early and repeat their last time and value."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 1.0, (B, N)), axis=1).astype(np.float32)
    times[:, 0] = 0.0
    values = np.exp(rng.normal(size=(B, N, 1)) * 0.3).astype(np.float32)
    mask = np.ones((B, N), bool)
    if padded:
        for b, n in ((1, 3), (4, 2)):
            mask[b, n:] = False
            times[b, n:] = times[b, n - 1]
            values[b, n:] = values[b, n - 1]
    traj = np.ones(B, bool)
    traj[-1] = False
    return times, values, mask, traj


def assert_close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_matches_jax(name):
    jax_model, params, port = bridged(**CONFIGS[name])
    times, values, mask, _ = batch()
    ref = jax_model.apply(params, jnp.asarray(times), jnp.asarray(values),
                          jnp.asarray(mask))
    ours = port.apply(torch.tensor(times), torch.tensor(values),
                      torch.tensor(mask))
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert_close(a, b)
    assert torch.all(ours[1][:, 0] == 0)      # zero before the first slot


def test_apply_without_grad_takes_the_gap_kernel_path():
    """Under no_grad an eligible ODEFunc integrates through
    integrate_gap_fused (its plain version here); the result still agrees
    with the JAX loop to the time-feature rounding."""
    jax_model, params, port = bridged(**CONFIGS["separate-dt"])
    times, values, mask, _ = batch(3)
    ref = jax_model.apply(params, jnp.asarray(times), jnp.asarray(values),
                          jnp.asarray(mask))
    from njode_tpu_torch.ops import gap_scan
    calls = []
    orig = gap_scan.gap_substeps

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    gap_scan.gap_substeps = spy
    try:
        with torch.no_grad():
            ours = port.apply(times, values, mask)
    finally:
        gap_scan.gap_substeps = orig
    assert calls
    for a, b in zip(ours, ref):
        assert_close(a, b)


def test_forward_ragged_matches_jax():
    jax_model, params, port = bridged(**CONFIGS["shared-dt"])
    rng = np.random.default_rng(5)
    lengths = [2, 5, 3]
    times = [np.concatenate([[0.0], np.sort(rng.uniform(0, 1, n - 1))])
             .astype(np.float32) for n in lengths]
    values = [rng.normal(size=(n, 1)).astype(np.float32) for n in lengths]
    ref, ref_b = jax_model.forward(params, [jnp.asarray(t) for t in times],
                                   [jnp.asarray(v) for v in values])
    ours, ours_b = port.forward(times, values)
    for a, b in zip(ours + ours_b, list(ref) + list(ref_b)):
        assert_close(a, b)


@pytest.mark.parametrize("name,method", [
    ("separate-single-step", "direct"), ("separate-tanh-scaled",
                                         "second_moment"),
    ("shared-dt", "direct"), ("separate-rk4", "direct")])
def test_apply_loss_and_parameter_grads_match_jax(name, method):
    cfg = CONFIGS[name]
    jax_model, params, port = bridged(seed=2, **cfg)
    times, values, mask, traj = batch(7)
    kw = dict(ignore_first_continuity=True, moment_weights=[1.0, 10.0],
              variance_method=method)
    args = (jnp.asarray(times), jnp.asarray(values), jnp.asarray(mask))
    ref, grads = jax.value_and_grad(
        lambda p: jax_model.apply_loss(p, *args, traj_mask=jnp.asarray(traj),
                                       **kw))(params)
    loss = port.apply_loss(times, values, mask, traj_mask=traj, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    ref_grads = state_dict_from_jax(
        grads, num_moments=port.num_moments,
        shared_network=cfg["shared_network"], n_hidden_layers=1)
    named = dict(port.named_parameters())
    assert set(named) == set(ref_grads)
    for key, g in ref_grads.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(),
                                   err_msg=key, **GRAD_TOL)


def test_substep_budget_raises_where_jax_raises():
    kw = dict(input_dim=1, hidden_dim=4, output_dim=1, num_moments=2,
              shared_network=True, dt_ode_step=0.1, t_max=0.3)
    jax_model = JaxModel(use_pallas=False, **kw)
    params = jax_model.init(jax.random.PRNGKey(0))
    port = NeuralJumpODE(**kw, device="cpu")
    ok = np.array([[0.0, 0.2, 0.5]], np.float32)        # gaps <= 0.4 budget
    bad = np.array([[0.0, 0.1, 0.9]], np.float32)       # a 0.8 gap
    v = np.ones((1, 3, 1), np.float32)
    jax_model.apply(params, jnp.asarray(ok), jnp.asarray(v))
    port.apply(ok, v)
    with pytest.raises(ValueError, match="substep budget"):
        jax_model.apply(params, jnp.asarray(bad), jnp.asarray(v))
    with pytest.raises(ValueError, match="substep budget"):
        port.apply(bad, v)


def test_dropout_draws_from_the_generator():
    """Training-mode dropout comes from the explicit generator alone: the
    same seed gives the same predictions, another seed others, and no
    generator (or training=False) applies none."""
    port = NeuralJumpODE(1, H, 1, num_moments=2, dropout_rate=0.3,
                         dt_ode_step=0.1, device="cpu")
    times, values, mask, _ = batch(9, padded=False)

    def run(seed=None, training=True):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return port.apply(times, values, generator=g, training=training)[1]
    a, b, c = run(1), run(1), run(2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(run(None), run(1, training=False), rtol=0,
                               atol=0)


def test_n_params_matches_jax():
    jax_model, params, port = bridged(**CONFIGS["separate-dt"])
    assert port.n_params() == jax_model.n_params(params)
