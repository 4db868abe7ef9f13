"""The port's ``ops`` and ``simulation`` packages against the JAX package's:
their exports, and the public entries of the fused step and the fused
Euler cell with the JAX signatures (the model takes the place of the JAX
parameter pytree).  CPU only: the wrappers take the kernels' plain
versions, the JAX side its Pallas kernels in interpret mode."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import njode_tpu.ops as jax_ops
import njode_tpu.simulation as jax_sim
import njode_tpu_torch.ops as ops
import njode_tpu_torch.simulation as sim
from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.ops import fused_cell as jfc
from njode_tpu.ops import fused_step as jfs
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.ops import fused_step as fs
from njode_tpu_torch.utils import state_dict_from_jax

# Pallas plumbing with no port (ROADMAP Queue 1 item 14)
NOT_PORTED = {"HAS_PALLAS"}


def _assert_ported(obj, ref, package):
    """A constant equals the JAX package's; a function or class is the
    port's own."""
    if isinstance(ref, tuple):
        assert obj == ref
    else:
        assert obj.__module__.startswith(package)


@pytest.mark.parametrize("name", sorted(set(jax_ops.__all__) - NOT_PORTED))
def test_ops_exports_follow_the_jax_package(name):
    assert name in ops.__all__
    _assert_ported(getattr(ops, name), getattr(jax_ops, name),
                   "njode_tpu_torch.ops")


@pytest.mark.parametrize("name", sorted(jax_sim.__all__))
def test_simulation_exports_follow_the_jax_package(name):
    assert name in sim.__all__
    _assert_ported(getattr(sim, name), getattr(jax_sim, name),
                   "njode_tpu_torch.simulation")


def test_fused_step_available_takes_the_jax_signature():
    """The JAX parameter list, ``shared_network`` first and unused, so a
    positional call written for JAX binds alike."""
    ours = list(inspect.signature(fs.fused_step_available).parameters)
    ref = list(inspect.signature(jfs.fused_step_available).parameters)
    assert ours == ref
    args = (1, 1, 1, "relu", 0.0, "identity", None)
    assert fs.fused_step_available(True, *args)
    assert fs.fused_step_available(False, *args)
    assert not fs.fused_step_available(False, 1, 1, 1, "relu", 0.0,
                                       "identity", 0.01)


H, B = 16, 5


def _bridged(shared, d=1, K=2, seed=0):
    cfg = dict(input_dim=d, hidden_dim=H, output_dim=d, num_moments=K,
               shared_network=shared)
    params = JaxModel(use_pallas="step-interpret", **cfg).init(
        jax.random.PRNGKey(seed))
    port = NeuralJumpODE(**cfg, use_pallas="step", device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=K, shared_network=shared, n_hidden_layers=1))
    return params, port


def _batch(N, d, seed=2):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 1, (B, N)), axis=1).astype(np.float32)
    times[:, 0] = 0.0
    values = (rng.normal(size=(B, N, d)) + 1.0).astype(np.float32)
    return times, values


@pytest.mark.parametrize("shared,d", [(False, 1), (True, 1), (False, 2)],
                         ids=["separate", "shared", "separate-d2"])
def test_model_entries_match_jax(shared, d):
    """fused_step_apply / fused_step_loss on the model against the JAX
    entries of those names on its parameter pytree (forward rtol 2e-5 /
    atol 2e-6, loss rtol 1e-5, the JAX package's own tolerances)."""
    params, port = _bridged(shared, d)
    times, values = _batch(4, d)
    jkw = dict(num_moments=2, hidden_dim=H, activation="relu",
               input_scaling="identity", interpret=True,
               shared_network=shared, input_dim=d, output_dim=d)
    ref = jfs.fused_step_apply(params, jnp.asarray(times),
                               jnp.asarray(values), **jkw)
    t, v = torch.tensor(times), torch.tensor(values)
    with torch.no_grad():
        ours = fs.fused_step_apply(port, t, v)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)
    kw = dict(ignore_first_continuity=True, moment_weights=[1.0, 10.0])
    l_ref = jfs.fused_step_loss(params, jnp.asarray(times),
                                jnp.asarray(values), **kw, **jkw)
    loss = fs.fused_step_loss(port, t, v, **kw)
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=1e-5)
    loss.backward()
    assert all(p.grad is not None for p in port.parameters())


def test_fused_euler_cell_matches_jax():
    """The single-network cell at logical shapes against the JAX entry on
    its padded tiles (interpret mode): rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(0)
    R, d_in, d_h = 7, 11, 9
    f = np.float32
    inp, h = rng.normal(size=(R, d_in)).astype(f), rng.normal(
        size=(R, d_h)).astype(f)
    dt = rng.uniform(0.01, 0.1, R).astype(f)
    w1, w2 = (rng.normal(size=s).astype(f) * 0.3
              for s in ((d_in, d_h), (d_h, d_h)))
    b1, b2 = rng.normal(size=d_h).astype(f), rng.normal(size=d_h).astype(f)
    ours = ops.fused_euler_cell(*(torch.tensor(x) for x in
                                  (inp, h, dt, w1, b1, w2, b2)), "tanh")
    Rp, L = jfc.ROW_TILE, jfc.LANES

    def pad(x, rows, cols):
        out = np.zeros((rows, cols), f)
        out[:x.shape[0], :x.shape[1]] = x
        return jnp.asarray(out)
    ref = jfc.fused_euler_cell(
        pad(inp, Rp, L), pad(h, Rp, L), pad(np.repeat(dt[:, None], d_h, 1),
                                            Rp, L),
        pad(w1, L, L), pad(b1[None], 1, L)[0], pad(w2, L, L),
        pad(b2[None], 1, L)[0], act_name="tanh", interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref)[:R, :d_h],
                               rtol=1e-5, atol=1e-6)
