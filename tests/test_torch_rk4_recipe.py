"""The rk4 production recipe (``scripts/run_production_rk4.sh``: hidden 50,
shared network, K 2, ``--ode-solver rk4`` at ``--dt-ode-step`` 0.05,
weights [1, 10], the CLI's lr and weight decay) on the port's composed
per-gap rk4 route, held against the JAX package on the CPU.

Its 0.01 grid is not a multiple of 0.05, so the grid walk is off and no
kernel carries a gap (the gap kernels are Euler only): every gap runs the
predicated rk4 loop under autograd.  Weights come in through
``state_dict_from_jax``; the data are seeded numpy Black-Scholes paths on a
100-step grid, handed to both Trainers with ``shuffle=False``.  Tolerances
are ``tests/test_torch_training.py``'s: losses rtol 2e-5, parameters and
Adam moments rtol 1e-4 / atol 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.utils.training import Trainer as JaxTrainer
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.utils import (Trainer, adam_state_from_jax, make_adam,
                                   state_dict_from_jax)
from njode_tpu_torch.utils import training as T

LOSS_TOL = dict(rtol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=2e-6)
CFG = chip_smoke.recipe_config("production-rk4", 2, "rk4")
MODEL_KW = dict(input_dim=1, hidden_dim=CFG["hidden_dim"], output_dim=1,
                num_moments=CFG["num_moments"],
                shared_network=CFG["shared_network"],
                dt_ode_step=CFG["dt_ode_step"], ode_solver=CFG["ode_solver"])
BRIDGE = dict(num_moments=2, shared_network=True, n_hidden_layers=1)
N_SLOTS, BS, N_TRAIN, N_VAL = 10, 8, 22, 6      # minibatches 8, 8, 6


def bs_paths(n, seed):
    """n Black-Scholes paths (mu 0.1, sigma 0.5, x0 1) on the 100-step grid
    of [0, 1], each observed at slot 0 and N_SLOTS - 1 other grid points."""
    rng = np.random.default_rng(seed)
    dt = 0.01
    w = np.cumsum(rng.normal(scale=np.sqrt(dt), size=(n, 100)), axis=1)
    t = np.arange(1, 101) * dt
    path = np.concatenate([np.ones((n, 1)),
                           np.exp((0.1 - 0.125) * t + 0.5 * w)], axis=1)
    idx = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 101), N_SLOTS - 1, replace=False)])
        for _ in range(n)]), axis=1)
    times = (idx * dt).astype(np.float32)
    values = np.take_along_axis(path, idx, axis=1)[..., None]
    return times, values.astype(np.float32)


@pytest.fixture(scope="module")
def jax_trained():
    """Two JAX epochs of the recipe's model (shuffle off, a ragged last
    minibatch) with validation: (initial params, history, params, Adam
    state)."""
    times, values = bs_paths(N_TRAIN, 0)
    vt, vv = bs_paths(N_VAL, 1)
    model = JaxModel(**MODEL_KW, use_pallas=False)
    trainer = JaxTrainer(model, jax_make_adam(CFG["learning_rate"],
                                              CFG["weight_decay"]),
                         ignore_first_continuity=True,
                         moment_weights=CFG["moment_weights"], seed=2)
    # a host copy: the JAX epoch program donates its parameter buffers
    init = jax.tree_util.tree_map(np.asarray, trainer.params)
    hist = trainer.train(lambda: (jnp.asarray(times), jnp.asarray(values)),
                         lambda: (jnp.asarray(vt), jnp.asarray(vv)),
                         n_epochs=2, batch_size=BS, shuffle=False,
                         print_every=1)
    return init, hist, trainer.params, trainer.opt_state


def test_composed_rk4_trainer_matches_jax_trainer(jax_trained, capsys):
    """The port's Trainer under --kernels auto on the CPU (the composed
    per-gap rk4 loop, named on the path line): per-epoch train and
    validation losses, parameters and Adam moments against the JAX
    Trainer's from the same bridged weights."""
    init, ref_hist, ref_params, ref_opt = jax_trained
    model = NeuralJumpODE(**MODEL_KW, device="cpu")
    model.load_state_dict(state_dict_from_jax(init, **BRIDGE))
    lr, wd = CFG["learning_rate"], CFG["weight_decay"]
    trainer = Trainer(model, make_adam(model.parameters(), lr, wd),
                      ignore_first_continuity=True,
                      moment_weights=CFG["moment_weights"], seed=2,
                      use_train_kernel="auto")
    times, values = bs_paths(N_TRAIN, 0)
    vt, vv = bs_paths(N_VAL, 1)
    hist = trainer.train(lambda: (times, values), lambda: (vt, vv),
                         n_epochs=2, batch_size=BS, shuffle=False,
                         print_every=1)
    assert ("Training path: composed (per-gap rk4 loop) from epoch 0"
            in capsys.readouterr().out)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], ref_hist[key], **LOSS_TOL)
    sd = model.state_dict()
    for key, val in state_dict_from_jax(ref_params, **BRIDGE).items():
        np.testing.assert_allclose(sd[key].numpy(), val.numpy(),
                                   err_msg=key, **STATE_TOL)
    ref = adam_state_from_jax(ref_opt, model, lr=lr, weight_decay=wd)
    ours = trainer.optimizer.state_dict()["state"]
    for i, s in ours.items():
        assert float(s["step"]) == float(ref["state"][i]["step"]) == 6
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(s[k].numpy(),
                                       ref["state"][i][k].numpy(),
                                       err_msg=f"{i} {k}", **STATE_TOL)


def test_debug_checks_pass_on_the_recipe_grid():
    """With debug_checks on, one apply of each package raises nothing: 20
    substeps of 0.05 reach every gap of [0, 1] (the JAX check runs inside
    its jitted loop, the port's after its loop), and the two agree."""
    times, values = bs_paths(4, 3)
    jm = JaxModel(**MODEL_KW, use_pallas=False, debug_checks=True)
    params = jm.init(jax.random.PRNGKey(1))
    ref = jm.apply(params, jnp.asarray(times), jnp.asarray(values))
    model = NeuralJumpODE(**MODEL_KW, debug_checks=True, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, **BRIDGE))
    assert model.max_substeps == 20
    ours = model.apply(torch.from_numpy(times), torch.from_numpy(values))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_no_kernel_on_the_card():
    """The gates as the card would see them, with no CUDA tensor built: no
    grid walk under "auto" (0.05 does not divide the 0.01 grid), no gap
    kernel in training or in validation (Euler only), no whole-run kernel
    (its walk twin needs the walk)."""
    cuda = torch.device("cuda")
    assert (CFG["ode_solver"], CFG["dt_ode_step"], CFG["use_pallas"]) == (
        "rk4", 0.05, "auto")
    assert not T._grid_walk_aligned(CFG)
    assert T._resolve_grid_walk(CFG, cuda, "auto") is False
    model = NeuralJumpODE(**MODEL_KW, device="cpu")
    assert model._use_gap_scan() is False
    assert model._use_gap_scan(inference=True) is False
    assert model._walks() is False and model._forced_route() is None
    trainer = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                      ignore_first_continuity=True, use_train_kernel="auto")
    trainer.device = cuda                               # the gate alone
    assert "grid_walk off" in trainer._kernel_decline(BS, N_SLOTS)
