"""The port's ``NeuralJumpODE.predict_on_grid`` held against the JAX
package's on the CPU, the JAX model's weights carried across.

Both run the same float32 arithmetic (``n_sub`` equal solver steps a grid
cell, a jump at each observed point, zeros before the first observation),
so the outputs agree to rtol 1e-5 / atol 1e-6: only the order of the f32
sums inside the products differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu_torch import NeuralJumpODE
from njode_tpu_torch.ops import fused_cell
from njode_tpu_torch.utils import state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)
G, B = 21, 3


def bridged(seed=0, **kw):
    kw = dict(dict(input_dim=1, hidden_dim=12, output_dim=1, num_moments=2,
                   t_max=1.0), **kw)
    jax_model = JaxModel(use_pallas=False, **kw)
    params = jax_model.init(jax.random.PRNGKey(seed))
    port = NeuralJumpODE(**kw, device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=kw["num_moments"],
        shared_network=kw.get("shared_network", False),
        n_hidden_layers=kw.get("n_hidden_layers", 1)))
    return jax_model, params, port


def grid_request(seed=0, n_grid=G, n_paths=B, d_x=1):
    """A float32 uniform grid on [0, 1]; observations at index 0 for path
    0 only, so the other paths read zeros until their first observation,
    and none after index n_grid - 4, so every path extrapolates."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(0.0, 1.0, n_grid).astype(np.float32)
    mask = rng.random((n_paths, n_grid)) < 0.3
    mask[:, 0] = False
    mask[0, 0] = True
    mask[:, n_grid - 3:] = False
    mask[np.arange(n_paths), 2 + np.arange(n_paths)] = True
    values = np.exp(rng.normal(size=(n_paths, n_grid, d_x)) * 0.3).astype(
        np.float32)
    return grid, mask, values


def assert_rollouts_match(jax_model, params, port, grid, mask, values,
                          n_sub=None):
    ref = jax_model.predict_on_grid(params, jnp.asarray(grid),
                                    jnp.asarray(mask), jnp.asarray(values),
                                    n_sub=n_sub)
    ours = port.predict_on_grid(torch.as_tensor(grid), torch.as_tensor(mask),
                                torch.as_tensor(values), n_sub=n_sub)
    for key in ("raw", "mean", "var"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   **TOL, err_msg=key)
    return ours


@pytest.mark.parametrize("n_sub", [None, 1, 3], ids=["derived", "1", "3"])
@pytest.mark.parametrize("solver", ["euler", "heun", "rk4"])
@pytest.mark.parametrize("method,shared", [("direct", True),
                                           ("second_moment", False)],
                         ids=["direct-shared", "second_moment-separate"])
def test_predict_on_grid_matches_jax(solver, n_sub, method, shared):
    jax_model, params, port = bridged(
        ode_solver=solver, variance_method=method, shared_network=shared,
        activation="tanh", dt_ode_step=0.02)
    grid, mask, values = grid_request(1)
    out = assert_rollouts_match(jax_model, params, port, grid, mask, values,
                                n_sub)
    # zeros before the first observation; extrapolated values after the last
    first = mask.argmax(axis=1)
    for b in range(B):
        assert (out["raw"][b, :first[b]] == 0).all()
        assert (out["raw"][b, first[b]:] != 0).all()


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "separate"])
def test_predict_on_grid_without_dt_ode_step(shared):
    """No dt_ode_step: one solver step a cell (the derived n_sub is 1)."""
    jax_model, params, port = bridged(shared_network=shared)
    assert port._grid_substeps(torch.linspace(0, 1, G)) == 1
    assert_rollouts_match(jax_model, params, port, *grid_request(2))


def test_substep_count_truncates_as_jax():
    """dt_ode_step 0.001 on a float32 100-step grid: the first cell is
    0.0099999998 in float64, so int(cell / dt) is 9 in both packages."""
    jax_model, params, port = bridged(dt_ode_step=0.001, hidden_dim=8)
    grid, mask, values = grid_request(3, n_grid=101, n_paths=2)
    assert port._grid_substeps(torch.as_tensor(grid)) == 9
    assert_rollouts_match(jax_model, params, port, grid, mask, values)


def test_non_uniform_grid_raises_with_jax_wording():
    jax_model, params, port = bridged(dt_ode_step=0.02, hidden_dim=8)
    grid, mask, values = grid_request(4)
    grid[5] += 0.02
    with pytest.raises(ValueError) as ref:
        jax_model.predict_on_grid(params, jnp.asarray(grid),
                                  jnp.asarray(mask), jnp.asarray(values))
    with pytest.raises(ValueError) as ours:
        port.predict_on_grid(grid, mask, values)
    assert str(ours.value) == str(ref.value)
    assert "uniform grid spacing" in str(ours.value)
    # an explicit n_sub needs no uniform grid
    assert_rollouts_match(jax_model, params, port, grid, mask, values, 2)


@pytest.mark.parametrize("dt", [0.02, None], ids=["dt", "no-dt"])
def test_forced_rollout_takes_the_cells_plain_version_on_the_cpu(dt):
    """use_pallas=True routes every substep through the fused Euler cell:
    on CPU tensors its plain version, which launches nothing and agrees
    with the unforced rollout."""
    kw = dict(input_dim=1, hidden_dim=12, output_dim=1, num_moments=2,
              dt_ode_step=dt, t_max=1.0, device="cpu")
    plain = NeuralJumpODE(**kw, generator=torch.Generator().manual_seed(3))
    forced = NeuralJumpODE(**kw, use_pallas=True,
                           generator=torch.Generator().manual_seed(3))
    assert forced._use_fused() and not plain._use_fused()
    grid, mask, values = grid_request(5)
    fused_cell.LAUNCHES = 0
    a = plain.predict_on_grid(grid, mask, values)
    b = forced.predict_on_grid(grid, mask, values)
    assert fused_cell.LAUNCHES == 0
    torch.testing.assert_close(b["raw"], a["raw"], rtol=1e-5, atol=1e-6)


def test_predict_on_grid_keeps_the_training_mode_and_takes_no_grad():
    _, _, port = bridged(dt_ode_step=0.05, hidden_dim=8)
    port.train()
    out = port.predict_on_grid(*grid_request(6))
    assert port.training and not out["raw"].requires_grad
    assert out["raw"].shape == (B, G, 1, 2)
