"""The port's training layer (njode_tpu_torch/utils/training.py,
checkpoint.py, the Adam bridge of weights.py) held against the JAX
package's on the CPU.

Weights come in through ``state_dict_from_jax`` and Adam state through
``adam_state_from_jax``; data from numpy with a fixed seed, handed to both
Trainers as a fixed (times, values) callable with ``shuffle=False`` (the two
packages' shuffles come from different generators).  Tolerances: per-epoch
losses rtol 2e-5, parameters and Adam moments rtol 1e-4 / atol 2e-6 (the
JAX package's own for its kernel against optax: f32 sums in other orders,
carried through Adam's normalised step).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.utils.training import Trainer as JaxTrainer
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.ops import train_kernel as tk
from njode_tpu_torch.utils import (DataLoader, Trainer, adam_state_from_jax,
                                   create_data_loaders, make_adam,
                                   run_experiment, state_dict_from_jax)

H, N, BS, NT = 12, 5, 16, 40
LOSS_TOL = dict(rtol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=2e-6)
LR, WD = 1e-3, 5e-4
BRIDGE = dict(num_moments=2, shared_network=False, n_hidden_layers=1)


def make_data(n=NT, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 100), N - 1, replace=False)])
        for _ in range(n)]), axis=1)
    times = (idx * 0.01).astype(np.float32)
    values = np.exp(rng.normal(size=(n, N, 1)) * 0.3).astype(np.float32)
    return times, values


def port_from_jax_params(params, **kw):
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(params, **BRIDGE))
    return model


def assert_state_close(model, jax_params):
    ref = state_dict_from_jax(jax_params, **BRIDGE)
    sd = model.state_dict()
    for key, val in ref.items():
        np.testing.assert_allclose(sd[key].numpy(), val.numpy(), err_msg=key,
                                   **STATE_TOL)


def test_adam_matches_make_adam_and_the_state_bridge():
    """torch.optim.Adam against make_adam over 5 steps on the same
    gradients; after 3 steps the JAX optimizer state, carried over by
    adam_state_from_jax, equals torch's and continues identically."""
    jax_model = JaxModel(input_dim=1, hidden_dim=H, output_dim=1,
                         num_moments=2, use_pallas=False)
    params = jax_model.init(jax.random.PRNGKey(3))
    tx = jax_make_adam(LR, WD)
    opt_state = tx.init(params)
    model = port_from_jax_params(params)
    opt = make_adam(model.parameters(), LR, WD)
    rng = np.random.default_rng(4)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    for step in range(5):
        grads = jax.tree_util.tree_unflatten(treedef, [
            rng.normal(size=leaf.shape).astype(np.float32) for leaf in leaves])
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        named = dict(model.named_parameters())
        for key, g in state_dict_from_jax(grads, **BRIDGE).items():
            named[key].grad = g.clone()
        opt.step()
        assert_state_close(model, params)
        if step == 2:
            bridged = adam_state_from_jax(opt_state, model, lr=LR,
                                          weight_decay=WD)
            ours = opt.state_dict()
            for i, s in ours["state"].items():
                for k in ("exp_avg", "exp_avg_sq"):
                    np.testing.assert_allclose(
                        s[k].numpy(), bridged["state"][i][k].numpy(),
                        **STATE_TOL)
                assert float(s["step"]) == float(bridged["state"][i]["step"])
            opt.load_state_dict(bridged)


@pytest.fixture(scope="module")
def jax_trained():
    """Three composed JAX epochs on fixed data (shuffle off, a padded last
    minibatch) with validation: (initial params, history, final params)."""
    times, values = make_data()
    vt, vv = make_data(12, seed=1)
    model = JaxModel(input_dim=1, hidden_dim=H, output_dim=1, num_moments=2,
                     use_pallas=False)
    trainer = JaxTrainer(model, jax_make_adam(LR, WD),
                         ignore_first_continuity=True,
                         moment_weights=[1.0, 10.0], seed=5)
    # a host copy: the JAX epoch program donates its parameter buffers
    init = jax.tree_util.tree_map(np.asarray, trainer.params)
    hist = trainer.train(lambda: (jnp.asarray(times), jnp.asarray(values)),
                         lambda: (jnp.asarray(vt), jnp.asarray(vv)),
                         n_epochs=3, batch_size=BS, shuffle=False,
                         print_every=1)
    return init, hist, trainer.params


def port_trainer(init, use_train_kernel=False):
    model = port_from_jax_params(init)
    return Trainer(model, make_adam(model.parameters(), LR, WD),
                   ignore_first_continuity=True, moment_weights=[1.0, 10.0],
                   seed=5, use_train_kernel=use_train_kernel)


def train_fixed(trainer, n_epochs=3, **kw):
    times, values = make_data()
    vt, vv = make_data(12, seed=1)
    return trainer.train(lambda: (times, values), lambda: (vt, vv),
                         n_epochs=n_epochs, batch_size=BS, shuffle=False,
                         print_every=1, **kw)


def test_composed_trainer_matches_jax_trainer(jax_trained):
    init, ref_hist, ref_params = jax_trained
    trainer = port_trainer(init)
    hist = train_fixed(trainer)
    np.testing.assert_allclose(hist["train_loss"], ref_hist["train_loss"],
                               **LOSS_TOL)
    np.testing.assert_allclose(hist["val_loss"], ref_hist["val_loss"],
                               **LOSS_TOL)
    assert_state_close(trainer.model, ref_params)


def test_kernel_trainer_on_cpu_matches_composed(jax_trained):
    """use_train_kernel=True on a CPU model runs the kernel's plain version,
    one call per epoch; losses and params match the composed path and the
    JAX Trainer."""
    init, ref_hist, ref_params = jax_trained
    trainer = port_trainer(init, use_train_kernel=True)
    tk.LAUNCHES = 0
    hist = train_fixed(trainer)
    assert tk.LAUNCHES == 0
    np.testing.assert_allclose(hist["train_loss"], ref_hist["train_loss"],
                               **LOSS_TOL)
    assert_state_close(trainer.model, ref_params)
    assert len(trainer.optimizer.state_dict()["state"]) == 24


def test_kernel_check_lists_problems_and_auto_stays_composed():
    model = NeuralJumpODE(1, H, 1, num_moments=2, shared_network=True,
                          device="cpu")
    trainer = Trainer(model, use_train_kernel=True)
    with pytest.raises(ValueError, match="model config.*ignore_first"):
        trainer._train_kernel_check(BS, N)
    auto = Trainer(NeuralJumpODE(1, H, 1, num_moments=2, device="cpu"),
                   ignore_first_continuity=True, use_train_kernel="auto")
    assert auto._use_kernel(BS, N) is False     # a CPU model: composed
    sgd = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                  use_train_kernel=True)
    assert any("torch.optim.Adam" in p for p in sgd._kernel_opts_problems())
    with pytest.raises(ValueError, match="interpret"):
        Trainer(model, use_train_kernel="interpret")


def ragged_data(seed, short):
    """make_data's trajectories, the first ``short`` of them cut to N - 2
    observations (as_dense pads them, masked, at the row end)."""
    times, values = make_data(seed=seed)
    cut = [N - 2] * short + [N] * (NT - short)
    return ([t[:n] for t, n in zip(times, cut)],
            [v[:n] for v, n in zip(values, cut)])


@pytest.mark.parametrize("first_short", [3, 0])
def test_kernel_path_refuses_padded_batches(first_short, capsys):
    """The kernel takes every slot as an observation, so a batch with padded
    slots never reaches it: use_train_kernel=True raises at the first such
    epoch (the first, or a later one after a full epoch trained), and
    "auto" resolves to the composed path for it."""
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu")
    trainer = Trainer(model, make_adam(model.parameters(), LR, WD),
                      ignore_first_continuity=True, use_train_kernel=True)
    batches = [ragged_data(0, first_short), ragged_data(1, 5)]
    with pytest.raises(ValueError, match="padded slots"):
        trainer.train(lambda epoch: batches[epoch], n_epochs=2,
                      batch_size=BS, shuffle=False)
    assert len(trainer.train_losses) == (0 if first_short else 1)

    auto = Trainer(NeuralJumpODE(1, H, 1, num_moments=2, device="cpu"),
                   ignore_first_continuity=True, use_train_kernel="auto")
    auto.device = torch.device("cuda")    # the gate alone; no CUDA tensor
    full = torch.ones(NT, N, dtype=torch.bool)
    padded = full.clone()
    padded[0, -1] = False
    assert auto._use_kernel(BS, N, full) is True
    assert auto._use_kernel(BS, N, padded) is False


def test_checkpoint_resume_early_return_and_corrupt_file(tmp_path, capsys):
    init = JaxModel(input_dim=1, hidden_dim=H, output_dim=1, num_moments=2,
                    use_pallas=False).init(jax.random.PRNGKey(8))
    ckpt = str(tmp_path / "model.ckpt")
    full = port_trainer(init)
    full_hist = train_fixed(full, n_epochs=4)

    first = port_trainer(init)
    train_fixed(first, n_epochs=2, save_path=ckpt)
    resumed = port_trainer(init)
    hist = train_fixed(resumed, n_epochs=4, save_path=ckpt)
    assert "Resuming from epoch 2" in capsys.readouterr().out
    assert len(hist["train_loss"]) == 4
    # shuffle off and a fixed data callable: the resumed run is the
    # uninterrupted one
    np.testing.assert_allclose(hist["train_loss"], full_hist["train_loss"],
                               rtol=1e-6)

    done = port_trainer(init)
    out = train_fixed(done, n_epochs=4, save_path=ckpt)
    assert out["resumed_from_checkpoint"] is True
    assert "already completed" in capsys.readouterr().out

    with open(ckpt, "wb") as f:
        f.write(b"not a checkpoint")
    fresh = port_trainer(init)
    hist = train_fixed(fresh, n_epochs=1, save_path=ckpt)
    assert "Starting fresh training" in capsys.readouterr().out
    assert len(hist["train_loss"]) == 1


def test_data_loader_cached_and_fresh():
    kw = dict(mu=0.1, sigma=0.5)
    train, val = create_data_loaders("black_scholes", n_train=8, n_val=4,
                                     cache_data=False, base_seed=3,
                                     obs_only=True, device="cpu", **kw)
    assert train(0).values.shape == (8, 10, 1)
    assert torch.equal(train(1).values, train(1).values)
    assert not torch.equal(train(0).values, train(1).values)
    assert val(0) is val(5)                      # validation always cached
    cached = DataLoader(3, 8, "black_scholes", 0.1, True, kw, obs_only=True,
                        device="cpu")
    assert cached(0) is cached(7)
    assert not torch.equal(val(0).values[:4], train(0).values[:4])


def _config(tmp_path, **over):
    cfg = {
        "experiment_name": "bs", "input_dim": 1, "hidden_dim": 8,
        "output_dim": 1, "n_hidden_layers": 1, "activation": "relu",
        "dropout_rate": 0.0, "input_scaling": "identity",
        "variance_method": "direct", "dt_ode_step": None,
        "ode_solver": "euler", "learning_rate": LR, "weight_decay": WD,
        "n_epochs": 2, "batch_size": 16, "shuffle": True, "print_every": 1,
        "device": "cpu", "ignore_first_continuity": True, "num_moments": 2,
        "moment_weights": [1.0, 10.0], "shared_network": False,
        "use_pallas": "auto", "grid_walk": "auto", "seed": 0, "data_seed": 0,
        "data": {"process_type": "black_scholes", "n_train": 24, "n_val": 8,
                 "obs_fraction": 0.1, "cache_data": False, "obs_only": True,
                 "T": 1.0, "n_steps": 100, "mu": 0.1, "sigma": 0.5,
                 "x0": 1.0}}
    cfg.update(over)
    return cfg


def test_run_experiment_writes_artifacts_and_resumes(tmp_path, capsys):
    res = run_experiment(_config(tmp_path), save_dir=str(tmp_path))
    run = tmp_path / "bs"
    for name in ("config.json", "model.ckpt", "history.json"):
        assert (run / name).is_file()
    hist = json.loads((run / "history.json").read_text())
    assert len(hist["train_loss"]) == 2 and len(hist["relative_loss"]) == 2
    assert np.isfinite(hist["train_loss"]).all()
    assert res["final_train_loss"] == hist["train_loss"][-1]
    assert "Training path: composed" in capsys.readouterr().out
    res = run_experiment(_config(tmp_path, n_epochs=3),
                         save_dir=str(tmp_path))
    assert "Resuming from epoch 2" in capsys.readouterr().out
    assert len(res["history"]["train_loss"]) == 3
    # use_pallas 'train' insists on the kernel: its plain version on the CPU
    res = run_experiment(_config(tmp_path, use_pallas="train",
                                 experiment_name="bs_kernel"),
                         save_dir=str(tmp_path))
    assert "Training path: whole-run kernel" in capsys.readouterr().out
    assert np.isfinite(res["history"]["train_loss"]).all()


@pytest.mark.parametrize("over,match", [
    (dict(ensemble=4), "ensembles"),
    (dict(data_parallel=2), "parallelism"),
    (dict(multihost=True), "parallelism"),
    (dict(dt_ode_step=0.01, grid_walk="on"), "grid walk"),
    (dict(compute_dtype="bfloat16"), "mixed precision"),
    (dict(use_pallas=True), "not ported"),
    (dict(use_pallas="step"), "not ported"),
    (dict(checkpoint_backend="orbax"), "Orbax"),
    (dict(data={"process_type": "ornstein_uhlenbeck"}), "not ported"),
])
def test_run_experiment_refuses_unported_paths(tmp_path, over, match):
    with pytest.raises(NotImplementedError, match=match):
        run_experiment(_config(tmp_path, **over), save_dir=str(tmp_path))
