"""The port's NJ-ODE loss (njode_tpu_torch/models/loss.py) held against the
JAX package's on the CPU: value, and gradients with respect to both
prediction tensors against ``jax.value_and_grad``.

Inputs come from numpy with a fixed seed.  Tolerance rtol 1e-5 / atol 1e-6:
both sides compute in f32 and differ only in the order of the sums over
observations and trajectories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu.models.loss import nj_ode_loss as jax_loss_ragged
from njode_tpu.models.loss import nj_ode_loss_dense as jax_loss
from njode_tpu_torch.models import nj_ode_loss, nj_ode_loss_dense

TOL = dict(rtol=1e-5, atol=1e-6)
B, N, D = 6, 5, 2

# (K, variance_method, ignore_first_continuity, end-padded mask, traj_mask,
#  moment_weights, extended_moments)
CASES = {
    "plain": (2, "direct", False, False, False, None, False),
    "first-off": (2, "direct", True, False, False, [1.0, 10.0], False),
    "second-moment-masked": (2, "second_moment", True, True, False,
                             [1.0, 10.0], False),
    "traj-mask": (2, "direct", True, True, True, [1.0, 10.0], False),
    "mean-only": (1, "direct", False, True, False, None, False),
    "extended-direct": (3, "direct", True, False, True, [1.0, 2.0, 3.0],
                        True),
    "extended-second": (3, "second_moment", False, True, True,
                        [1.0, 2.0, 0.5], True),
    "extended-off": (3, "direct", False, False, False, None, False),
}


def _inputs(seed, K):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    values = rng.normal(size=(B, N, D)).astype(f32)
    preds = rng.normal(size=(B, N, D, K)).astype(f32)
    before = rng.normal(size=(B, N, D, K)).astype(f32)
    mask = np.ones((B, N), bool)
    mask[1, 3:] = False
    mask[4, 2:] = False
    traj = np.array([True, True, False, True, True, False])
    return values, preds, before, mask, traj


@pytest.fixture(scope="module")
def jax_results():
    """Each case's JAX value and gradients, computed once."""
    out = {}
    for i, (name, (K, method, first, masked, tm, mw, ext)) in enumerate(
            CASES.items()):
        values, preds, before, mask, traj = _inputs(i, K)
        kw = dict(ignore_first_continuity=first, moment_weights=mw,
                  variance_method=method, extended_moments=ext,
                  traj_mask=jnp.asarray(traj) if tm else None)
        m = jnp.asarray(mask) if masked else None
        val, grads = jax.value_and_grad(
            lambda p, pb: jax_loss(jnp.asarray(values), p, pb, m, **kw),
            argnums=(0, 1))(jnp.asarray(preds), jnp.asarray(before))
        out[name] = (float(val), [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_dense_loss_value_and_grads_match_jax(name, jax_results):
    i = list(CASES).index(name)
    K, method, first, masked, tm, mw, ext = CASES[name]
    values, preds, before, mask, traj = _inputs(i, K)
    p = torch.tensor(preds, requires_grad=True)
    pb = torch.tensor(before, requires_grad=True)
    loss = nj_ode_loss_dense(
        torch.tensor(values), p, pb, torch.tensor(mask) if masked else None,
        ignore_first_continuity=first, moment_weights=mw,
        variance_method=method, extended_moments=ext,
        traj_mask=torch.tensor(traj) if tm else None)
    loss.backward()
    val, (g, gb) = jax_results[name]
    np.testing.assert_allclose(loss.item(), val, **TOL)
    np.testing.assert_allclose(p.grad.numpy(), g, **TOL)
    np.testing.assert_allclose(pb.grad.numpy(), gb, **TOL)


def test_ragged_loss_matches_jax():
    """The reference's ragged-list entry point: per-trajectory arrays of
    different lengths, padded inside both packages."""
    rng = np.random.default_rng(11)
    lengths = [3, 5, 2, 4]
    times = [np.sort(rng.uniform(0, 1, n)).astype(np.float32)
             for n in lengths]
    values = [rng.normal(size=(n, 1)).astype(np.float32) for n in lengths]
    preds = [rng.normal(size=(n, 1, 2)).astype(np.float32) for n in lengths]
    before = [rng.normal(size=(n, 1, 2)).astype(np.float32) for n in lengths]
    kw = dict(ignore_first_continuity=True, moment_weights=[1.0, 10.0])
    ours = nj_ode_loss([torch.tensor(t) for t in times],
                       [torch.tensor(v) for v in values],
                       [torch.tensor(p) for p in preds],
                       [torch.tensor(p) for p in before], **kw)
    ref = jax_loss_ragged([jnp.asarray(t) for t in times],
                          [jnp.asarray(v) for v in values],
                          [jnp.asarray(p) for p in preds],
                          [jnp.asarray(p) for p in before], **kw)
    np.testing.assert_allclose(float(ours), float(ref), **TOL)


def test_unknown_variance_method_raises():
    x = torch.zeros(2, 3, 1)
    p = torch.zeros(2, 3, 1, 2)
    with pytest.raises(ValueError, match="variance_method"):
        nj_ode_loss_dense(x, p, p, variance_method="softplus")
