"""The whole-run training kernels' bf16 mode (``mxu_dtype="bfloat16"``,
rows 11b-12b and 13b) held against the JAX package's on the CPU.

``fused_train_run`` and ``fused_walk_train_run`` of the port run their plain
versions on CPU tensors; the JAX kernels run in Pallas interpret mode with
``mxu_dtype="bfloat16"``, at the sizes of the f32 twins' tests
(tests/test_torch_train_kernel.py: H 12, N 5, batch 16;
tests/test_torch_walk_train.py: the same with dt 0.05, M 20), from weights
carried across by the weight bridge.  The CUDA kernels' bf16 instances are
held against these plain versions on the card by ``chip_smoke.py``.

Tolerances.  Both sides round the same operands to bf16 and sum products
that are exact in f32, so only the order of the f32 sums differs; the
tolerances are the f32 twins' own (run: losses rtol 2e-5, params, m and v
rtol 1e-4 / atol 2e-6; walk: rtol 2e-4 / atol 1e-5), far inside the JAX
package's bf16-against-f32 bounds (losses rtol 5e-3, params rtol 0.1 / atol
1e-3, tests/test_train_kernel.py:467-471; Trainer losses rtol 0.05,
tests/test_walk_train.py:477-481).  The ratio test pins the rounding points:
the distance from the port's bf16 run to JAX's must be at most 0.1 x the
distance from JAX's bf16 run to its f32 run (measured about 1e-3 x), so a
mode that rounds elsewhere (row 11's points on row 13: x, t, w1x, w1t, cvec
and b2 unrounded) fails it.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_kernel as run_twin
import test_torch_walk_train as walk_twin
from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.ops import train_kernel as jtk
from njode_tpu.ops import walk_train as jwt
from njode_tpu.utils.training import Trainer as JaxTrainer
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.ops import pack_minibatches
from njode_tpu_torch.ops import train_kernel as tk
from njode_tpu_torch.ops import walk_train as wt
from njode_tpu_torch.utils import (Trainer, make_adam, run_experiment,
                                   state_dict_from_jax)

BF16 = "bfloat16"
RATIO = 0.1

# run twin: K, variance_method, activation, input_scaling, G, padded
RUN_CASES = {
    "dual-direct": (2, "direct", "relu", "identity", 3, True),
    "dual-second-moment": (2, "second_moment", "relu", "identity", 3, False),
    "mean-only": (1, "direct", "tanh", "tanh", 3, True),
}
# walk twin: K, variance_method, solver, activation, scaling, G, padded
WALK_CASES = {
    "euler-direct": (2, "direct", "euler", "relu", "identity", 3, True),
    "euler-mean-only": (1, "second_moment", "euler", "tanh", "tanh", 2,
                        False),
    "heun": (2, "direct", "heun", "relu", "identity", 2, False),
}


def _bridge(tree, K, shared):
    return state_dict_from_jax(tree, num_moments=K, shared_network=shared,
                               n_hidden_layers=1)


@functools.cache
def jax_run_twin(name, mxu):
    """The JAX kernel's (losses, params, m, v), the state as port
    state-dict entries."""
    K, method, act, scale, G, padded = RUN_CASES[name]
    times, values, valid = run_twin.make_data(G, padded)
    params = run_twin.jax_params(K, act, scale)
    data = jtk.pack_minibatches(jnp.asarray(times), jnp.asarray(values),
                                jnp.asarray(valid), run_twin.BS)
    st = jtk.init_train_state(params, num_moments=K, hidden_dim=run_twin.H)
    st, losses = jtk.fused_train_run(
        st, data, n_slots=run_twin.N, num_moments=K,
        batch_size=run_twin.BS, lr=run_twin.LR, weight_decay=run_twin.WD,
        variance_method=method, activation=act, input_scaling=scale,
        interpret=True, mxu_dtype=mxu)
    opt = jax_make_adam(run_twin.LR, run_twin.WD).init(params)
    p, opt = jtk.optax_state_into(st, G, opt, num_moments=K,
                                  hidden_dim=run_twin.H)
    adam = jtk._find_adam_state(opt)[1]
    return (np.asarray(losses), _bridge(p, K, False),
            _bridge(adam.mu, K, False), _bridge(adam.nu, K, False))


def port_run_twin(name, mxu=BF16):
    K, method, act, scale, G, padded = RUN_CASES[name]
    times, values, valid = run_twin.make_data(G, padded)
    model = run_twin.port_model(K, act, scale,
                                run_twin.jax_params(K, act, scale))
    data = tk.pack_minibatches(torch.tensor(times), torch.tensor(values),
                               torch.tensor(valid), run_twin.BS)
    st, losses = tk.fused_train_run(
        tk.init_train_state(model), data, n_slots=run_twin.N,
        num_moments=K, batch_size=run_twin.BS, lr=run_twin.LR,
        weight_decay=run_twin.WD, variance_method=method, activation=act,
        input_scaling=scale, mxu_dtype=mxu)
    H = run_twin.H
    return (losses.numpy(), tk._unpack(st.params, H), tk._unpack(st.m, H),
            tk._unpack(st.v, H))


@functools.cache
def jax_walk_twin(name, mxu):
    K, method, solver, act, scale, G, padded = WALK_CASES[name]
    times, values, valid = walk_twin.make_data(G, padded)
    params = walk_twin.jax_params(K, act, scale, solver)
    data = jtk.pack_minibatches(jnp.asarray(times), jnp.asarray(values),
                                jnp.asarray(valid), walk_twin.BS)
    st = jwt.init_walk_state(params, num_moments=K, hidden_dim=walk_twin.H)
    st, losses = jwt.fused_walk_train_run(
        st, data, interpret=True, mxu_dtype=mxu,
        **walk_twin.kwargs(K, method, solver, act, scale))
    opt = jax_make_adam(walk_twin.LR, walk_twin.WD).init(params)
    p, opt = jwt.optax_state_into_walk(st, G, opt, num_moments=K,
                                       hidden_dim=walk_twin.H)
    adam = next(s for s in opt if hasattr(s, "mu"))
    return (np.asarray(losses), _bridge(p, K, True), _bridge(adam.mu, K, True),
            _bridge(adam.nu, K, True))


def port_walk_twin(name, mxu=BF16):
    K, method, solver, act, scale, G, padded = WALK_CASES[name]
    times, values, valid = walk_twin.make_data(G, padded)
    model = walk_twin.port_model(K, act, scale, solver,
                                 walk_twin.jax_params(K, act, scale, solver))
    data = pack_minibatches(torch.tensor(times), torch.tensor(values),
                            torch.tensor(valid), walk_twin.BS)
    st, losses = wt.fused_walk_train_run(
        wt.init_walk_state(model), data, mxu_dtype=mxu,
        **walk_twin.kwargs(K, method, solver, act, scale))
    H = walk_twin.H
    return (losses.numpy(), wt._unpack(st.params, H, K),
            wt._unpack(st.m, H, K), wt._unpack(st.v, H, K))


def assert_runs_close(ours, ref, loss_tol, state_tol):
    np.testing.assert_allclose(ours[0], ref[0], **loss_tol)
    for mine, theirs, what in zip(ours[1:], ref[1:], ("params", "m", "v")):
        assert set(mine) == set(theirs)
        for key in theirs:
            np.testing.assert_allclose(mine[key].numpy(),
                                       theirs[key].numpy(),
                                       err_msg=f"{what} {key}", **state_tol)


@pytest.mark.parametrize("name", list(RUN_CASES))
def test_run_twin_plain_version_matches_jax_bf16(name):
    assert_runs_close(port_run_twin(name), jax_run_twin(name, BF16),
                      run_twin.LOSS_TOL, run_twin.STATE_TOL)


@pytest.mark.parametrize("name", list(WALK_CASES))
def test_walk_twin_plain_version_matches_jax_bf16(name):
    assert_runs_close(port_walk_twin(name), jax_walk_twin(name, BF16),
                      walk_twin.TOL, walk_twin.TOL)


def _flat(run):
    """losses, then every parameter entry, as one float64 vector each."""
    return (np.asarray(run[0], np.float64),
            np.concatenate([np.asarray(run[1][k], np.float64).ravel()
                            for k in sorted(run[1])]))


@pytest.mark.parametrize("twin,name", [("run", "dual-direct"),
                                       ("run", "mean-only"),
                                       ("walk", "euler-direct"),
                                       ("walk", "heun")])
def test_rounding_points_ratio(twin, name):
    """|port bf16 - JAX bf16| <= 0.1 |JAX bf16 - JAX f32|, for the per-step
    losses and for the parameters (largest entry of each): the port's bf16
    mode rounds where JAX's does, not merely somewhere."""
    port, jax_run = ((port_run_twin, jax_run_twin) if twin == "run"
                     else (port_walk_twin, jax_walk_twin))
    ours = _flat(port(name))
    bf, f32 = _flat(jax_run(name, BF16)), _flat(jax_run(name, "float32"))
    for what, a, b, c in zip(("losses", "params"), ours, bf, f32):
        mode_gap = np.abs(b - c).max()
        assert mode_gap > 0, what                      # bf16 rounding is real
        assert np.abs(a - b).max() <= RATIO * mode_gap, what


def test_ratio_test_catches_row_11_rounding_on_row_13(monkeypatch):
    """The walk twin with row 11's rounding points (its walk products'
    x, t, w1x, w1t, cvec and b2 columns left in f32) misses JAX's bf16
    mode by more than the ratio allows."""
    real = wt.RoundedMM.apply

    def only_square(a, w):
        if a.shape[-1] == w.shape[-1]:
            return real(a, w)
        h = w.shape[-1]                 # [.., extra cols] @ [W; extra rows]
        return (real(a[..., :h], w[:h])
                + torch.matmul(a[..., h:], w[h:]))
    monkeypatch.setattr(wt.RoundedMM, "apply", only_square)
    ours = _flat(port_walk_twin("euler-direct"))
    bf = _flat(jax_walk_twin("euler-direct", BF16))
    f32 = _flat(jax_walk_twin("euler-direct", "float32"))
    assert np.abs(ours[1] - bf[1]).max() > RATIO * np.abs(bf[1] - f32[1]).max()


def test_bf16_runs_differ_from_f32():
    """The mode is real on both twins' plain versions."""
    for port, name in ((port_run_twin, "dual-direct"),
                       (port_walk_twin, "euler-direct")):
        bf, f32 = _flat(port(name)), _flat(port(name, "float32"))
        assert not np.array_equal(bf[1], f32[1])
        np.testing.assert_allclose(bf[0], f32[0], rtol=5e-3)


@pytest.mark.parametrize("K,act,scale", [(2, "relu", "identity"),
                                         (1, "tanh", "tanh")])
def test_zero_padding_of_hidden_units_is_exact_under_bf16(K, act, scale):
    """H 10 padded to 12 with zero units under the bf16 products: zeros
    round to zero, so the padded run equals the run on the state itself
    bitwise and the extra units' params, m and v stay exactly zero."""
    H0, Hp = 10, tk.padded_hidden(10)
    times, values, valid = run_twin.make_data(3, True)
    model = NeuralJumpODE(1, H0, 1, num_moments=K, activation=act,
                          input_scaling=scale, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    data = tk.pack_minibatches(torch.tensor(times), torch.tensor(values),
                               torch.tensor(valid), run_twin.BS)
    kw = dict(n_slots=run_twin.N, num_moments=K, batch_size=run_twin.BS,
              lr=run_twin.LR, weight_decay=run_twin.WD, activation=act,
              input_scaling=scale, mxu_dtype=BF16)
    state, _ = tk.fused_train_run_reference(tk.init_train_state(model),
                                            data, **kw)
    padded = tk.pad_state(state, H0, Hp)
    ours, ours_l = tk.fused_train_run_reference(padded, data, **kw)
    ref, ref_l = tk.fused_train_run_reference(state, data, **kw)
    for x in ours[:3]:
        assert torch.equal(tk.pad_state(tk.unpad_state(
            tk.TrainState(x, x, x, ours.stat), Hp, H0), H0, Hp).params, x)
    assert torch.equal(ours_l, ref_l)
    for a, b in zip(tk.unpad_state(ours, Hp, H0), ref):
        assert torch.equal(a, b)


def test_float16_refused_by_name_and_cpu_calls_launch_nothing():
    state, data = run_twin._args()
    kw = dict(n_slots=run_twin.N, num_moments=2, batch_size=run_twin.BS)
    with pytest.raises(ValueError, match="mxu_dtype"):
        tk.fused_train_run(state, data, mxu_dtype="float16", **kw)
    with pytest.raises(ValueError, match="mxu_dtype"):
        tk.fused_train_run_reference(state, data, mxu_dtype="float16", **kw)
    model, wdata, wkw = walk_twin.port_state("euler-direct")
    wst = wt.init_walk_state(model)
    with pytest.raises(ValueError, match="mxu_dtype"):
        wt.fused_walk_train_run(wst, wdata, **wkw, mxu_dtype="float16")
    tk.LAUNCHES = tk.LAUNCHES_BF16 = wt.LAUNCHES = wt.LAUNCHES_BF16 = 0
    before = [x.clone() for x in state]
    out, losses = tk.fused_train_run(state, data, mxu_dtype=BF16, **kw)
    wout, wlosses = wt.fused_walk_train_run(wst, wdata, **wkw,
                                            mxu_dtype=BF16)
    assert (tk.LAUNCHES, tk.LAUNCHES_BF16, wt.LAUNCHES,
            wt.LAUNCHES_BF16) == (0, 0, 0, 0)
    assert torch.isfinite(losses).all() and torch.isfinite(wlosses).all()
    assert all(torch.equal(a, b) for a, b in zip(state, before))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.fused_train_run(state, data.to("meta"), mxu_dtype=BF16, **kw)


# ----------------------------------------------------------------------
# the Trainer and run_experiment
# ----------------------------------------------------------------------

H, N, BS = 12, 5, 16
LR, WD = 1e-3, 5e-4
TRAINER_TOL = dict(rtol=2e-4)


def jax_loaders(walk):
    from njode_tpu.utils.training import create_data_loaders as loaders
    n_steps = 20 if walk else 100
    return loaders(process_type="black_scholes", n_train=2 * BS, n_val=8,
                   obs_fraction=N / n_steps, n_steps=n_steps,
                   cache_data=True, base_seed=0, obs_only=True, mu=0.1,
                   sigma=0.5, x0=1.0)


def model_kw(walk):
    kw = dict(input_dim=1, hidden_dim=H, output_dim=1, num_moments=2)
    if walk:
        kw.update(shared_network=True, dt_ode_step=0.05, t_max=1.0,
                  grid_walk=True)
    return kw


@functools.cache
def jax_trainer_run(walk, mxu):
    """Three epochs of the JAX Trainer's whole-run twin (interpret mode)
    with train_kernel_opts mxu_dtype: (initial params, history, data)."""
    jtr = JaxTrainer(JaxModel(**model_kw(walk)), jax_make_adam(LR, WD),
                     ignore_first_continuity=True,
                     moment_weights=[1.0, 10.0], seed=0,
                     use_train_kernel="interpret",
                     train_kernel_opts=dict(lr=LR, weight_decay=WD,
                                            mxu_dtype=mxu))
    init = jax.tree_util.tree_map(np.asarray, jtr.params)
    train_fn, val_fn = jax_loaders(walk)
    hist = jtr.train(train_fn, val_fn, n_epochs=3, batch_size=BS,
                     shuffle=False, print_every=1)
    tb, vb = train_fn(0), val_fn(0)
    data = ((np.array(tb.times), np.array(tb.values)),
            (np.array(vb.times), np.array(vb.values)))
    return init, hist, data


def port_trainer(walk, init, **kw):
    model = NeuralJumpODE(**model_kw(walk), device="cpu")
    model.load_state_dict(_bridge(init, 2, walk))
    return Trainer(model, make_adam(model.parameters(), LR, WD),
                   ignore_first_continuity=True, moment_weights=[1.0, 10.0],
                   **kw)


@pytest.mark.parametrize("walk", [False, True], ids=["run", "walk"])
def test_trainer_bf16_matches_jax_trainer(walk, capsys):
    """Trainer(use_train_kernel=True, train_kernel_opts={"mxu_dtype":
    "bfloat16"}) runs the twin's bf16 plain version, one call per epoch,
    and reproduces the JAX Trainer's bf16 twin on the same data: per-epoch
    train and validation losses at rtol 2e-4; the f32 JAX Trainer is
    further away than that."""
    init, ref, (data, val) = jax_trainer_run(walk, BF16)
    trainer = port_trainer(walk, init, use_train_kernel=True,
                           train_kernel_opts={"mxu_dtype": BF16})
    hist = trainer.train(lambda: data, lambda: val, n_epochs=3,
                         batch_size=BS, shuffle=False, print_every=1)
    kernel = "walk-train kernel" if walk else "whole-run kernel"
    assert f"Training path: {kernel} (bfloat16 products)" in \
        capsys.readouterr().out
    np.testing.assert_allclose(hist["train_loss"], ref["train_loss"],
                               **TRAINER_TOL)
    np.testing.assert_allclose(hist["val_loss"], ref["val_loss"],
                               **TRAINER_TOL)
    f32 = jax_trainer_run(walk, "float32")[1]["train_loss"]
    assert not np.allclose(hist["train_loss"], f32, rtol=1e-7)
    np.testing.assert_allclose(hist["train_loss"], f32, rtol=0.05)


def test_composed_route_ignores_the_option(capsys):
    """As in the JAX package, mxu_dtype is the whole-run kernels' option:
    the composed path (use_train_kernel False, or "auto" on the CPU)
    trains bitwise as without it."""
    init, _, (data, val) = jax_trainer_run(False, BF16)
    hists = []
    for kw in (dict(), dict(train_kernel_opts={"mxu_dtype": BF16}),
               dict(use_train_kernel="auto",
                    train_kernel_opts={"mxu_dtype": BF16})):
        hists.append(port_trainer(False, init, **kw).train(
            lambda: data, lambda: val, n_epochs=2, batch_size=BS,
            shuffle=False, print_every=1))
    assert capsys.readouterr().out.count("Training path: composed") == 3
    assert hists[0] == {**hists[1], "epoch_times": hists[0]["epoch_times"]}
    assert hists[1]["train_loss"] == hists[2]["train_loss"]


def test_kernel_check_names_mxu_and_hyperparameters():
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu")
    trainer = Trainer(model, make_adam(model.parameters(), LR, WD),
                      ignore_first_continuity=True, use_train_kernel=True,
                      train_kernel_opts={"mxu_dtype": "float16", "lr": 0.1,
                                         "weight_decay": WD})
    with pytest.raises(ValueError, match="mxu_dtype") as info:
        trainer._train_kernel_check(BS, N)
    msg = str(info.value)
    assert "'float16'" in msg and "train_kernel_opts['lr']=0.1" in msg
    assert "weight_decay" not in msg
    walk = NeuralJumpODE(**model_kw(True), device="cpu")
    wtr = Trainer(walk, make_adam(walk.parameters(), LR, WD),
                  ignore_first_continuity=True, use_train_kernel="auto",
                  train_kernel_opts={"mxu_dtype": "float16"})
    with pytest.raises(ValueError, match="mxu_dtype"):
        wtr._walk_train_check(BS, N)
    wtr.device = torch.device("cuda")                   # the gate alone
    assert wtr._use_kernel(BS, N) is False
    wtr.train_kernel_opts["mxu_dtype"] = BF16
    assert wtr._use_kernel(BS, N) is True


@pytest.mark.parametrize("opts", [{"adam_eps": 1e-6}, {"betas": (0.5, 0.9)}],
                         ids=["adam_eps", "betas"])
def test_kernel_check_names_adam_eps_and_betas(opts):
    """train_kernel_opts' adam_eps and betas, where they differ from a
    default Adam's, are listed as problems by the port's check and by the
    JAX package's (njode_tpu/utils/training.py:446-458) on the same setup;
    equal values are not."""
    (key, value), = opts.items()
    base = {"lr": LR, "weight_decay": WD}
    jtr = JaxTrainer(JaxModel(**model_kw(False)), jax_make_adam(LR, WD),
                     ignore_first_continuity=True, use_train_kernel=False,
                     train_kernel_opts={**base, **opts})
    assert any(f"train_kernel_opts[{key!r}]" in p
               for p in jtr._kernel_opts_problems())
    model = NeuralJumpODE(**model_kw(False), device="cpu")
    tr = Trainer(model, make_adam(model.parameters(), LR, WD),
                 ignore_first_continuity=True, use_train_kernel=True,
                 train_kernel_opts={**base, **opts})
    problems = tr._kernel_opts_problems()
    assert len(problems) == 1 and f"train_kernel_opts[{key!r}]" in problems[0]
    with pytest.raises(ValueError, match=key):
        tr._train_kernel_check(BS, N)
    same = {"adam_eps": 1e-8, "betas": (0.9, 0.999)}[key]
    tr.train_kernel_opts[key] = same
    assert tr._kernel_opts_problems() == []


def _config(tmp_path, walk, **over):
    cfg = {
        "experiment_name": "bf16_walk" if walk else "bf16_run",
        "input_dim": 1, "hidden_dim": 8, "output_dim": 1,
        "n_hidden_layers": 1, "activation": "relu", "dropout_rate": 0.0,
        "input_scaling": "identity", "variance_method": "direct",
        "dt_ode_step": 0.05 if walk else None, "ode_solver": "euler",
        "learning_rate": LR, "weight_decay": WD, "n_epochs": 2,
        "batch_size": 16, "shuffle": True, "print_every": 1, "device": "cpu",
        "ignore_first_continuity": True, "num_moments": 2,
        "moment_weights": [1.0, 10.0], "shared_network": walk,
        "use_pallas": "train", "grid_walk": "on" if walk else "auto",
        "train_kernel_mxu": BF16, "seed": 0, "data_seed": 0,
        "data": {"process_type": "black_scholes", "n_train": 24, "n_val": 8,
                 "obs_fraction": N / 20 if walk else 0.1,
                 "cache_data": False, "obs_only": True, "T": 1.0,
                 "n_steps": 20 if walk else 100, "mu": 0.1, "sigma": 0.5,
                 "x0": 1.0}}
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("walk", [False, True], ids=["run", "walk"])
def test_run_experiment_bf16_resumes_in_the_mode(tmp_path, walk, capsys):
    """run_experiment with train_kernel_mxu "bfloat16" and use_pallas
    "train" trains on the twin's bf16 plain version; the saved config
    carries the mode, and a run resumed from epoch 2 to 3 gives the losses
    of an uninterrupted 3-epoch bf16 run, not those of an f32 run."""
    cfg = _config(tmp_path, walk)
    run_experiment(cfg, save_dir=str(tmp_path))
    saved = tmp_path / cfg["experiment_name"] / "config.json"
    assert json.loads(saved.read_text())["train_kernel_mxu"] == BF16
    res = run_experiment(_config(tmp_path, walk, n_epochs=3),
                         save_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert "Resuming from epoch 2" in out and "(bfloat16 products)" in out
    resumed = res["history"]["train_loss"]
    straight = run_experiment(
        _config(tmp_path, walk, n_epochs=3, experiment_name="straight"),
        save_dir=str(tmp_path))["history"]["train_loss"]
    f32 = run_experiment(
        _config(tmp_path, walk, n_epochs=3, experiment_name="f32",
                train_kernel_mxu="float32"),
        save_dir=str(tmp_path))["history"]["train_loss"]
    np.testing.assert_allclose(resumed, straight, rtol=1e-6)
    assert not np.allclose(resumed, f32, rtol=1e-7)
    np.testing.assert_allclose(resumed, f32, rtol=0.05)
