"""The port's grid walk (``NeuralJumpODE(grid_walk=True)``,
njode_tpu_torch/models/jump_ode.py ``_integrate_gaps_grid``) held against
the JAX model's on the CPU, with the JAX weights carried across.

* ``use_pallas=False``: the plain walk with the XLA walk's time features,
  against the JAX model's XLA walk, for euler, heun and rk4: outputs and
  the parameter gradients of the training loss.
* ``use_pallas="auto"``: the kernel route, whose plain version the CPU
  runs, against the JAX walk kernel in interpret mode.
* The port's walk against its own per-gap path, at f32 roundoff (the two
  differ by about an ulp in their time features).
* The guards: off-grid, duplicate and out-of-grid times, ``debug_checks``,
  and ``grid_walk=True`` without ``dt_ode_step``.

Tolerances: outputs rtol 1e-5 / atol 1e-6; gradients rtol 1e-4 with atol
1e-6 of the largest entry (f32 sums in other orders through 20 compounded
cells and the loss's square roots).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.models.loss import nj_ode_loss_dense as jax_loss
from njode_tpu_torch import NeuralJumpODE
from njode_tpu_torch.ops import walk_scan
from njode_tpu_torch.utils import state_dict_from_jax

DT, N, B, H = 0.05, 5, 8, 12
OUT_TOL = dict(rtol=1e-5, atol=1e-6)


def grid_data(seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    cells = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 21), N - 1, replace=False)])
        for _ in range(B)]), axis=1)
    mask = np.ones((B, N), bool)
    if ragged:
        mask[1, 3:] = False
        cells[1, 3:] = cells[1, 2]
    times = (cells * DT).astype(np.float32)
    values = np.exp(rng.normal(size=(B, N, 1)) * 0.3).astype(np.float32)
    return times, values, mask


def bridged(port_pallas, jax_pallas, seed=0, **kw):
    cfg = dict(input_dim=1, hidden_dim=H, output_dim=1, num_moments=2,
               dt_ode_step=DT, t_max=1.0, grid_walk=True, **kw)
    jm = JaxModel(use_pallas=jax_pallas, **cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    pm = NeuralJumpODE(**cfg, use_pallas=port_pallas, device="cpu")
    pm.load_state_dict(state_dict_from_jax(
        params, num_moments=2, shared_network=cfg.get("shared_network", False),
        n_hidden_layers=1))
    return jm, params, pm


def loss_kw():
    return dict(ignore_first_continuity=True, moment_weights=[1.0, 10.0])


@pytest.mark.parametrize("solver,shared,port_pallas,jax_pallas", [
    ("euler", True, False, False),
    ("heun", False, False, False),
    ("rk4", True, False, False),
    ("euler", False, "auto", "interpret"),
])
def test_grid_walk_matches_jax(solver, shared, port_pallas, jax_pallas):
    times, values, mask = grid_data(seed=3)
    jm, params, pm = bridged(port_pallas, jax_pallas, ode_solver=solver,
                             shared_network=shared)
    jt, jv, jmask = (jnp.asarray(a) for a in (times, values, mask))

    def jl(p):
        pr, pb = jm.apply(p, jt, jv, jmask)
        return jax_loss(jv, pr, pb, jmask, **loss_kw()), (pr, pb)

    (l_ref, (pr_ref, pb_ref)), g_ref = jax.value_and_grad(
        jl, has_aux=True)(params)
    walk_scan.LAUNCHES_FWD = 0
    pr, pb = pm.apply(times, values, mask)
    np.testing.assert_allclose(pr.detach().numpy(), np.asarray(pr_ref),
                               **OUT_TOL)
    np.testing.assert_allclose(pb.detach().numpy(), np.asarray(pb_ref),
                               **OUT_TOL)
    loss = pm.apply_loss(times, values, mask, **loss_kw())
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=1e-5)
    loss.backward()
    assert walk_scan.LAUNCHES_FWD == 0
    ref = state_dict_from_jax(g_ref, num_moments=2, shared_network=shared,
                              n_hidden_layers=1)
    for name, p in pm.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, err_msg=name,
                                   rtol=1e-4, atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("port_pallas", [False, "auto"])
def test_grid_walk_matches_per_gap_path(port_pallas):
    times, values, mask = grid_data(seed=5, ragged=False)
    _, _, walk = bridged(port_pallas, False, shared_network=True)
    per_gap = NeuralJumpODE(1, H, 1, num_moments=2, dt_ode_step=DT,
                            t_max=1.0, shared_network=True, device="cpu")
    per_gap.load_state_dict(walk.state_dict())
    with torch.no_grad():
        a = walk.apply(times, values)
        b = per_gap.apply(times, values)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("change,match", [
    ("off_grid", "not multiples"),
    ("duplicate", "strictly increasing"),
    ("beyond", "exceeds the integration grid"),
])
def test_alignment_refusals(change, match):
    times, values, mask = grid_data(ragged=False)
    if change == "off_grid":
        times[2, 2] += 0.3 * DT
    elif change == "duplicate":
        times[2, 2] = times[2, 1]
    else:
        times[2, -1] = 1.2
    _, _, pm = bridged(False, False)
    with pytest.raises(ValueError, match=match):
        pm.apply(times, values, mask)


def test_debug_checks_and_constructor_refusal():
    times, values, mask = grid_data(ragged=False)
    times[0, 1] += 0.3 * DT
    _, _, pm = bridged(False, False, debug_checks=True)
    with pytest.raises(ValueError, match="off the integration grid"):
        pm._integrate_gaps_grid(torch.zeros(2, B, N, H), torch.tensor(times),
                                torch.tensor(values), None)
    with pytest.raises(ValueError, match="requires dt_ode_step"):
        NeuralJumpODE(1, H, 1, grid_walk=True, device="cpu")


def test_walk_routing():
    """Under "auto" the walk takes the kernel route wherever the kernels
    apply (euler, no dropout) and the per-gap path elsewhere; False keeps
    the plain walk.  Only on the card does a walk without autograd leave
    the kernel route for the per-gap one."""
    _, _, auto = bridged("auto", False)
    _, _, plain = bridged(False, False)
    _, _, heun = bridged("auto", False, ode_solver="heun")
    assert auto._use_walk_kernel() and not plain._use_walk_kernel()
    assert not heun._use_walk_kernel()
    assert auto._use_walk_kernel(inference=True)
