"""The port's ensembles (``njode_tpu_torch/utils/ensemble.py``, the ensemble
route of ``run_experiment``, plotting's seed bands) on the CPU, mirroring
``tests/test_ensemble.py`` and held against the JAX package.

* Port alone: members distinct and training, member s bitwise the same in
  ensembles of size 1, 2 and 3, ``share_data``, the validation stream apart
  from every training epoch's, the kernel policy inside an ensemble, the
  first-class experiment and its exact resume.
* Against JAX on identical inputs (stacks bridged by
  ``ensemble_state_from_jax``, data fed as numpy): one full-batch and one
  ``shuffle=False`` minibatch epoch of each member against
  ``jax.vmap(trainer._epoch_update)`` (params and loss at rtol 1e-5 / atol
  1e-6, then a second epoch from the bridged Adam state of each member),
  ``ensemble_predict`` / ``ensemble_mean_std``, ``_ensemble_rel_eval``'s
  ``l_true`` and the seed-band rollout within 1e-5, and the history.json
  keys of the same config.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.utils import ensemble as jax_ens
from njode_tpu.utils import training as jax_training
from njode_tpu_torch import NeuralJumpODE
from njode_tpu_torch.utils import (ensemble_mean_std, ensemble_predict,
                                   ensemble_state_from_jax, init_ensemble,
                                   load_checkpoint, run_experiment,
                                   state_dict_from_jax, train_ensemble)
from njode_tpu_torch.utils import adam_state_from_jax, make_adam
from njode_tpu_torch.utils import ensemble as ens
from njode_tpu_torch.utils.training import (STREAM_TRAIN, STREAM_VAL,
                                            _ensemble_rel_eval,
                                            _rel_l_true, _resolve_grid_walk,
                                            stream_seed)

MODEL_KW = dict(input_dim=1, hidden_dim=8, output_dim=1, num_moments=2,
                n_hidden_layers=1)
TRAIN_KW = dict(n_trajectories=32, batch_size=16, obs_fraction=0.2,
                n_steps=20, T=1.0, mu=0.1, sigma=0.5, x0=1.0)
BRIDGE = dict(num_moments=2, shared_network=False, n_hidden_layers=1)
EPOCH_TOL = dict(rtol=1e-5, atol=1e-6)
LR, WD = 1e-3, 5e-4


def port_model(**kw):
    return NeuralJumpODE(**{**MODEL_KW, **kw}, device="cpu")


def assert_stacks_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- port alone

def test_members_are_distinct_and_train():
    """Every member's loss on its fixed validation batch falls over 12
    epochs (32 fresh trajectories an epoch make the training losses
    themselves too noisy to rank)."""
    params, _, hist = ens.train_ensemble_full(
        port_model(), "black_scholes", n_seeds=3, n_epochs=12, n_val=64,
        **TRAIN_KW)
    losses = hist["train"]
    assert losses.shape == hist["val"].shape == (12, 3)
    assert torch.isfinite(losses).all()
    assert (hist["val"][-1] < hist["val"][0]).all()
    leaf = params["jump_nns.0.net.0.weight"]
    assert leaf.shape[0] == 3
    assert not torch.allclose(leaf[0], leaf[1])
    assert not torch.allclose(losses[:, 0], losses[:, 1])


@pytest.mark.parametrize("share_data", [False, True],
                         ids=["own-data", "shared-data"])
def test_member_identity_across_ensemble_sizes(share_data):
    """Member s depends only on (seed, s): members of the K=1, 2 and 3 runs
    are bitwise equal, losses and parameters, validation and relative loss
    included."""
    model = port_model()
    runs = {}
    for k in (1, 2, 3):
        rel = _ensemble_rel_eval(
            {"data": dict(process_type="black_scholes", n_train=32,
                          obs_fraction=0.2, n_steps=20, T=1.0, mu=0.1,
                          sigma=0.5, x0=1.0),
             "data_seed": 0}, model, k, share_data=share_data)
        runs[k] = ens.train_ensemble_full(
            model, "black_scholes", n_seeds=k, n_epochs=3, n_val=8,
            rel_eval=rel, share_data=share_data, **TRAIN_KW)
    for k in (2, 3):
        members = list(range(k - 1))
        for part in ("train", "val", "rel"):
            assert torch.equal(runs[k][2][part][:, :k - 1],
                               runs[k - 1][2][part]), part
        assert_stacks_equal({n: t[members] for n, t in runs[k][0].items()},
                            runs[k - 1][0])


def test_share_data_isolates_init_variance():
    """share_data=True: every member reads data_seed's streams, yet the
    members start apart and stay distinct."""
    assert ens._member_seeds(7, 3, share_data=True) == [7, 7, 7]
    assert len(set(ens._member_seeds(7, 3))) == 3
    _, losses = train_ensemble(port_model(), "black_scholes", n_seeds=2,
                               n_epochs=3, share_data=True, **TRAIN_KW)
    assert torch.isfinite(losses).all()
    assert not torch.allclose(losses[:, 0], losses[:, 1])
    stack = init_ensemble(port_model(), 2)
    assert not torch.equal(stack["ode_funcs.0.net.0.weight"][0],
                           stack["ode_funcs.0.net.0.weight"][1])


@pytest.mark.parametrize("share_data", [False, True],
                         ids=["own-data", "shared-data"])
def test_validation_stream_never_is_a_training_epoch(share_data):
    """A member's validation batch is its STREAM_VAL stream at epoch 0: no
    training epoch's seed (10,000 epochs) is it, and its data differs from
    the first epochs' (the collision JAX's validation tag avoids,
    njode_tpu/utils/ensemble.py:209-213)."""
    for ds in ens._member_seeds(0, 4, share_data):
        val = stream_seed(ds, STREAM_VAL, 0)
        assert val not in {stream_seed(ds, STREAM_TRAIN, e)
                           for e in range(10_000)}
    ds = ens._member_seeds(0, 1, share_data)[0]

    def loader(stream):
        return ens.DataLoader(ds, 8, "black_scholes", 0.2, False,
                              dict(n_steps=20), obs_only=True, stream=stream,
                              device="cpu")
    val, train = loader(STREAM_VAL)(0), loader(STREAM_TRAIN)
    for e in range(3):
        assert not torch.equal(val.values, train(e).values)


@pytest.mark.parametrize("policy,inside", [("auto", False), (True, True),
                                           ("step", "step")],
                         ids=["auto", "force", "step"])
def test_kernel_policy_inside_the_ensemble(policy, inside, monkeypatch):
    """'auto' trains the members on private copies with the kernels off (the
    JAX package's rule); True and 'step' are kept, so the members run the
    forced and fused-step kernels (their plain versions here).  The
    caller's model keeps its policy."""
    seen = []

    class Spy(ens.Trainer):
        def __init__(self, model, *a, **kw):
            seen.append(model.use_pallas)
            super().__init__(model, *a, **kw)

    monkeypatch.setattr(ens, "Trainer", Spy)
    model = port_model(use_pallas=policy)
    _, losses = train_ensemble(model, "black_scholes", n_seeds=2, n_epochs=1,
                               **TRAIN_KW)
    assert torch.isfinite(losses).all()
    assert seen == [inside, inside]
    assert model.use_pallas == policy


def test_grid_walk_policy_for_ensembles():
    """The grid walk is off for an ensemble under 'auto' even where a
    single model on the card would walk; 'on' still walks
    (njode_tpu/utils/training.py:1179-1191)."""
    cfg = {"dt_ode_step": 0.01, "hidden_dim": 50, "shared_network": True,
           "grid_walk": "auto",
           "data": {"T": 1.0, "n_steps": 100}}
    cuda = torch.device("cuda")
    assert _resolve_grid_walk(cfg, cuda, "auto") is True
    assert _resolve_grid_walk({**cfg, "ensemble": 2}, cuda, "auto") is False
    assert _resolve_grid_walk({**cfg, "ensemble": 2, "grid_walk": "on"},
                              cuda, "auto") is True


def test_init_ensemble_is_the_models_init():
    """Member s of a stack is NeuralJumpODE's init from a CPU generator
    seeded with member s's seed, shared and separate networks."""
    for kw in (dict(), dict(shared_network=True, dt_ode_step=0.05)):
        model = port_model(**kw)
        stack = init_ensemble(model, 3, seed=5)
        for s, ms in enumerate(ens._member_seeds(5, 3)):
            ref = port_model(**kw, generator=torch.Generator().manual_seed(
                ms)).state_dict()
            assert stack.keys() == ref.keys()
            for k, v in ref.items():
                assert torch.equal(stack[k][s], v), k


def test_ensemble_state_bridge():
    jax_model = JaxModel(use_pallas=False, **MODEL_KW)
    stack = jax_ens.init_ensemble(jax_model, 3, seed=0)
    ours = ensemble_state_from_jax(stack, **BRIDGE)
    for s in range(3):
        ref = state_dict_from_jax(jax.tree_util.tree_map(lambda x: x[s],
                                                         stack), **BRIDGE)
        for k, v in ref.items():
            assert torch.equal(ours[k][s], v), k
    port_model().load_state_dict(ens.member_state(ours, 2))


def test_mesh_and_device_parallel_ensembles_raise(tmp_path, monkeypatch):
    """Ensembles over ranks train now (tests/test_torch_distributed.py; a
    mesh raised here): a 1-rank mesh trains every member as no mesh does,
    and --multihost in a single process runs as one.  What still raises:
    --ensemble 3 beside --data-parallel 2 (the JAX package's message).  A
    --model-parallel beside an ensemble without a device request is the
    JAX package's single-device ensemble (its ensemble route builds a mesh
    only from --data-parallel or --multihost)."""
    from njode_tpu_torch.parallel import make_mesh
    ref = train_ensemble(port_model(), "black_scholes", n_seeds=2,
                         n_epochs=1, **TRAIN_KW)
    got = train_ensemble(port_model(), "black_scholes", n_seeds=2,
                         n_epochs=1, mesh=make_mesh(devices=["cpu"]),
                         **TRAIN_KW)
    assert_stacks_equal(got[0], ref[0])
    assert torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="cannot shard over 2 devices"):
        run_experiment(dict(ens_config(), data_parallel=2),
                       save_dir=str(tmp_path))
    res = run_experiment(dict(ens_config(n_epochs=1, experiment_name="mp"),
                              model_parallel=2), save_dir=str(tmp_path))
    assert np.asarray(res["history"]["member_train_loss"]).shape == (1, 3)
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE",
                "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    res = run_experiment(dict(ens_config(n_epochs=1), multihost=True),
                         save_dir=str(tmp_path))
    assert np.asarray(res["history"]["member_train_loss"]).shape == (1, 3)


def test_kernels_train_with_an_ensemble_raises_as_jax(tmp_path):
    cfg = ens_config(use_pallas="train")
    with pytest.raises(ValueError) as jax_err:
        jax_training.run_experiment(jax_config(cfg),
                                    save_dir=str(tmp_path / "jax"))
    with pytest.raises(ValueError) as ours:
        run_experiment(cfg, save_dir=str(tmp_path / "port"))
    assert str(ours.value) == str(jax_err.value)


# ----------------------------------------------------- against the JAX package

def epoch_data(n=40, N=6, seed=0, K=2):
    """(K, n, N) float32 times on the 0.05 grid from 0, lognormal values,
    the last trajectory of each member short (padded slots)."""
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 21), N - 1, replace=False)])
        for _ in range(n)]) for _ in range(K)]), axis=2)
    times = (idx * 0.05).astype(np.float32)
    values = np.exp(rng.normal(size=(K, n, N, 1)) * 0.3).astype(np.float32)
    mask = np.ones((K, n, N), bool)
    mask[:, -1, -2:] = False
    times[:, -1, -2:] = times[:, -1, -3:-2]
    return times, values, mask


def jax_epoch(trainer, params, opt_state, data, batch_size):
    times, values, mask = (jnp.asarray(x) for x in data)
    n = times.shape[1]
    keys = jax.vmap(lambda s: jax.random.PRNGKey(s))(jnp.arange(2))
    return jax.vmap(lambda p, s, t, v, m, k: trainer._epoch_update(
        p, s, t, v, m, k, n, batch_size, False))(params, opt_state, times,
                                                 values, mask, keys)


def assert_members_match(trainers, jax_params, what):
    for s, tr in enumerate(trainers):
        ref = state_dict_from_jax(jax.tree_util.tree_map(
            lambda x: np.asarray(x)[s], jax_params), **BRIDGE)
        sd = tr.model.state_dict()
        for k, v in ref.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                       err_msg=f"{what}: member {s} {k}",
                                       **EPOCH_TOL)


def run_member_epochs(trainers, data, epoch, batch_size):
    times, values, mask = (torch.as_tensor(x) for x in data)
    return [float(tr._epoch_update(times[s], values[s], mask[s], epoch,
                                   batch_size, False))
            for s, tr in enumerate(trainers)]


def member_trainers(stack, tx, hparams=None):
    kw = dict(ignore_first_continuity=True, moment_weights=[1.0, 10.0],
              variance_method="direct", extended_moments=False)
    return ens._members(port_model(use_pallas=False), stack, None, tx,
                        hparams, ens._member_seeds(0, 2), kw)


@pytest.mark.parametrize("batch_size", [None, 16],
                         ids=["full-batch", "minibatch"])
def test_member_epochs_match_jax(batch_size):
    """Each member's epoch (the single model's ``_epoch_update``) against
    the JAX package's vmapped one on the same stack and data; then a
    second epoch from each member's Adam state bridged out of JAX's stacked
    state (``adam_state_from_jax(member=s)``)."""
    jax_model = JaxModel(use_pallas=False, **MODEL_KW)
    tx = jax_training.make_adam(LR, WD)
    trainer = jax_training.Trainer(jax_model, tx,
                                   ignore_first_continuity=True,
                                   moment_weights=[1.0, 10.0])
    params = jax_ens.init_ensemble(jax_model, 2, seed=3)
    opt_state = jax.vmap(tx.init)(params)
    data = epoch_data()
    port_stack = ensemble_state_from_jax(params, **BRIDGE)
    trainers = member_trainers(port_stack, lambda p: make_adam(p, LR, WD))
    p1, s1, l1 = jax_epoch(trainer, params, opt_state, data, batch_size)
    ours = run_member_epochs(trainers, data, 0, batch_size)
    np.testing.assert_allclose(ours, np.asarray(l1), **EPOCH_TOL)
    assert_members_match(trainers, p1, "epoch 0")
    # the second epoch from JAX's state, bridged a member at a time
    bridged = member_trainers(ensemble_state_from_jax(p1, **BRIDGE),
                              lambda p: make_adam(p, LR, WD))
    for s, tr in enumerate(bridged):
        tr.optimizer.load_state_dict(adam_state_from_jax(
            s1, tr.model, lr=LR, weight_decay=WD, member=s))
    p2, _, l2 = jax_epoch(trainer, p1, s1, data, batch_size)
    ours = run_member_epochs(bridged, data, 1, batch_size)
    np.testing.assert_allclose(ours, np.asarray(l2), **EPOCH_TOL)
    assert_members_match(bridged, p2, "epoch 1")


@pytest.mark.parametrize("dt", [None, 0.05], ids=["one-step", "dt_ode_step"])
def test_ensemble_predict_and_mean_std_match_jax(dt):
    """ensemble_predict (each member's apply without autograd: with
    dt_ode_step the gap kernel's plain version) and ensemble_mean_std
    against the JAX package's on the same stack and batch, within 1e-5."""
    kw = dict(MODEL_KW, dt_ode_step=dt, t_max=1.0)
    jax_model = JaxModel(use_pallas=False, **kw)
    stack = jax_ens.init_ensemble(jax_model, 4, seed=1)
    times, values, mask = epoch_data(n=8, K=1)
    ref = jax_ens.ensemble_predict(jax_model, stack, jnp.asarray(times[0]),
                                   jnp.asarray(values[0]),
                                   jnp.asarray(mask[0]))
    model = NeuralJumpODE(**kw, device="cpu")
    ours = ensemble_predict(model, ensemble_state_from_jax(stack, **BRIDGE),
                            torch.as_tensor(times[0]),
                            torch.as_tensor(values[0]),
                            torch.as_tensor(mask[0]))
    B, N = times.shape[1:]
    for a, b in zip(ours, ref):
        assert a.shape == (4, B, N, 1, 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    mean, std = ensemble_mean_std(ours[1])
    ref_mean, ref_std = jax_ens.ensemble_mean_std(jnp.asarray(
        ours[1].numpy()))
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.asarray(ref_std), rtol=1e-5,
                               atol=1e-6)
    assert (std >= 0).all() and (std > 0).any()


def test_rel_eval_l_true_matches_jax():
    """The true-predictor losses of _ensemble_rel_eval on JAX's own
    relative-loss batches (10 trajectories of each member's epoch-0
    stream) within 1e-5; the port's own batches have the shape."""
    cfg = ens_config()
    jax_model = JaxModel(use_pallas=False, **MODEL_KW)
    ref = jax_training._ensemble_rel_eval(cfg, jax_model, 3)
    model = port_model()
    l_true = _rel_l_true(cfg, model, *(torch.tensor(np.array(ref[k]))
                                       for k in ("times", "values", "mask")))
    np.testing.assert_allclose(l_true.numpy(), np.asarray(ref["l_true"]),
                               rtol=1e-5, atol=1e-7)
    ours = _ensemble_rel_eval(cfg, model, 3)
    assert ours["times"].shape == tuple(np.asarray(ref["times"]).shape)
    assert ours["l_true"].shape == (3,) and (ours["l_true"] > 0).all()


def test_seed_band_rollout_matches_jax():
    """The arrays plotting draws for the seed bands (every member's
    predict_on_grid on one path: member means, their mean and population
    std, the mean variance) against the JAX package's vmap of
    predict_on_grid on the same stack, within 1e-5."""
    kw = dict(MODEL_KW, dt_ode_step=0.05, t_max=1.0)
    jax_model = JaxModel(use_pallas=False, **kw)
    stack = jax_ens.init_ensemble(jax_model, 3, seed=2)
    rng = np.random.default_rng(0)
    grid = np.linspace(0.0, 1.0, 21).astype(np.float32)
    path = np.exp(np.cumsum(rng.normal(size=21) * 0.1)).astype(np.float32)
    mask = np.zeros((1, 21), bool)
    mask[0, [0, 4, 9, 15]] = True
    outs = jax.vmap(lambda p: jax_model.predict_on_grid(
        p, jnp.asarray(grid), jnp.asarray(mask),
        jnp.asarray(path)[None, :, None]))(stack)
    member_means = np.asarray(outs["mean"][:, 0, :, 0])
    bands = ens.seed_bands(NeuralJumpODE(**kw, device="cpu"),
                           ensemble_state_from_jax(stack, **BRIDGE),
                           torch.as_tensor(grid), torch.as_tensor(mask),
                           torch.as_tensor(path)[None, :, None])
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bands["member_means"], member_means, **tol)
    np.testing.assert_allclose(bands["mean"], member_means.mean(axis=0),
                               **tol)
    np.testing.assert_allclose(bands["seed_std"], member_means.std(axis=0),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        bands["var"], np.asarray(outs["var"][:, 0, :, 0]).mean(axis=0),
        **tol)


# --------------------------------------------------- the first-class route

def ens_config(**over):
    cfg = dict(
        experiment_name="ens_exp", input_dim=1, hidden_dim=8, output_dim=1,
        n_hidden_layers=1, activation="relu", learning_rate=1e-2,
        weight_decay=5e-4, n_epochs=6, batch_size=16, shuffle=True,
        print_every=2, ignore_first_continuity=True, num_moments=2,
        moment_weights=[1.0, 10.0], ensemble=3, seed=0, data_seed=0,
        device="cpu",
        data=dict(process_type="black_scholes", n_train=32, n_val=16,
                  obs_fraction=0.2, cache_data=False, obs_only=True,
                  mu=0.1, sigma=0.5, T=1.0, n_steps=20, x0=1.0))
    cfg.update(over)
    return cfg


def jax_config(cfg):
    return {k: v for k, v in copy.deepcopy(cfg).items() if k != "device"}


def test_ensemble_experiment_first_class(tmp_path):
    """run_experiment with ensemble 3 records val and relative loss a member
    and keeps the single model's schema; history.json has the JAX
    package's keys for the same config."""
    res = run_experiment(ens_config(), save_dir=str(tmp_path / "port"))
    h = res["history"]
    assert len(h["train_loss"]) == 6 and len(h["val_loss"]) == 6
    assert res["final_val_loss"] is not None and len(h["epoch_times"]) == 6
    # relative loss at the print cadence (epochs 0, 2, 4)
    assert len(h["relative_loss"]) == 3
    assert all(np.isfinite(h["relative_loss"]))
    for k in ("member_train_loss", "member_val_loss",
              "member_relative_loss"):
        assert np.asarray(h[k]).shape == (6, 3), k
    np.testing.assert_allclose(
        h["val_loss"], np.asarray(h["member_val_loss"]).mean(axis=1),
        rtol=1e-12)
    on_disk = json.loads((tmp_path / "port" / "ens_exp"
                          / "history.json").read_text())
    assert on_disk["n_ensemble"] == 3 and len(on_disk["val_loss"]) == 6
    jax_training.run_experiment(jax_config(ens_config()),
                                save_dir=str(tmp_path / "jax"))
    ref = json.loads((tmp_path / "jax" / "ens_exp"
                      / "history.json").read_text())
    assert set(on_disk) == set(ref)


def test_ensemble_experiment_resume(tmp_path, capsys):
    """2 epochs, then 6 from the checkpoint, give the member rows and the
    stack of a fresh 6-epoch run bitwise; "(resumed)" marks only the first
    line after the resume; a complete run returns early."""
    full = run_experiment(ens_config(), save_dir=str(tmp_path / "full"))
    run_experiment(ens_config(n_epochs=2), save_dir=str(tmp_path / "split"))
    capsys.readouterr()
    res = run_experiment(ens_config(), save_dir=str(tmp_path / "split"))
    out = capsys.readouterr().out
    assert "Resuming 3-member ensemble from epoch 2" in out
    assert out.count("(resumed)") == 1
    assert "Trained 3-member ensemble x 4 epochs" in out
    h = res["history"]
    assert h.get("resumed_from_checkpoint") is True
    for k in ("member_train_loss", "member_val_loss",
              "member_relative_loss", "train_loss"):
        assert h[k] == full["history"][k], k
    assert_stacks_equal(res["params_stack"], full["params_stack"])
    res3 = run_experiment(ens_config(), save_dir=str(tmp_path / "split"))
    assert "Training already completed (6 epochs)" in capsys.readouterr().out
    assert len(res3["history"]["train_loss"]) == 6
    assert_stacks_equal(res3["params_stack"], full["params_stack"])


def test_ensemble_checkpoint_roundtrip(tmp_path):
    """The stacked checkpoint: the stack, an Adam state a member, the member
    loss matrices; it loads back bitwise, and a member's state loads into a
    model of the run's architecture."""
    res = run_experiment(ens_config(n_epochs=2), save_dir=str(tmp_path))
    stack, opt_states, hists = load_checkpoint(
        str(tmp_path / "ens_exp" / "model.ckpt"))
    assert_stacks_equal(stack, res["params_stack"])
    assert isinstance(opt_states, list) and len(opt_states) == 3
    assert hists["member_train_loss"] == res["history"]["member_train_loss"]
    model = port_model()
    model.load_state_dict(ens.member_state(stack, 1))
    opt = make_adam(model.parameters(), 1e-2, 5e-4)
    opt.load_state_dict(opt_states[1])
    assert float(opt.state_dict()["state"][0]["step"]) == 2 * 2


def test_plotted_seed_bands(tmp_path, monkeypatch):
    """The trajectory plot of a stack draws the ensemble mean, each member
    faintly and the ±2σ seed band, from seed_bands' arrays."""
    from njode_tpu_torch.utils import plotting
    figs = []
    monkeypatch.setattr(plotting.plt, "close", figs.append)
    model = port_model(dt_ode_step=0.05)
    stack = init_ensemble(model, 3, seed=0)
    out = tmp_path / "fig.png"
    plotting.plot_single_trajectory_with_condexp(
        model, "black_scholes", dict(mu=0.1, sigma=0.5, T=1.0, n_steps=20,
                                     x0=1.0),
        obs_fraction=0.2, save_path=str(out), ensemble_params=stack)
    assert out.stat().st_size > 0
    (fig,) = figs
    ax = fig.axes[0]
    lines = {ln.get_label(): ln for ln in ax.get_lines()}
    labels = {c.get_label() for c in ax.collections}
    assert "Seed ±2σ (3 members)" in labels and "Model ±2σ" in labels
    assert "Ensemble Mean" in lines and "Model Mean" not in lines
    members = [ln for ln in ax.get_lines() if ln.get_label().startswith("_")]
    assert len(members) == 3
    np.testing.assert_allclose(
        lines["Ensemble Mean"].get_ydata(),
        np.mean([m.get_ydata() for m in members], axis=0), rtol=1e-6)


def test_chip_smoke_forced_ensemble_config():
    """chip_smoke.py phase 38a's config: scripts/run_black_scholes.sh's
    flags with --ensemble 4 --kernels force, on which the grid walk
    resolves off (a single model of the same flags would walk), so the
    members train through the gap loop's training pair."""
    import chip_smoke
    cfg = chip_smoke.ens_forced_config(4, 2, "x")
    assert cfg["ensemble"] == 4 and cfg["use_pallas"] is True
    assert cfg["dt_ode_step"] == 0.01 and cfg["shared_network"]
    assert cfg["data"]["n_train"] == 10_000 and cfg["batch_size"] == 256
    cuda = torch.device("cuda")
    assert _resolve_grid_walk(cfg, cuda, True) is False
    assert _resolve_grid_walk({**cfg, "ensemble": 0}, cuda, True) is True


def test_cli_ensemble_run_plots_the_seed_bands(tmp_path, monkeypatch):
    """run_and_plot's ensemble branch: the stacked checkpoint loads as the
    plot's ensemble_params and the three PNGs are written."""
    from njode_tpu_torch.experiments import experiment_black_scholes
    monkeypatch.chdir(tmp_path)
    experiment_black_scholes.main(
        ["--device", "cpu", "--n-train", "8", "--n-val", "4", "--n-epochs",
         "2", "--batch-size", "4", "--n-steps", "20", "--ensemble", "2"])
    run = tmp_path / "runs" / "njode_black_scholes"
    for png in ("training_history.png", "relative_loss.png",
                "trajectory_comparison.png"):
        assert (run / png).stat().st_size > 0, png
    stack, _, _ = load_checkpoint(str(run / "model.ckpt"))
    assert stack["jump_nns.0.net.0.weight"].shape[0] == 2
