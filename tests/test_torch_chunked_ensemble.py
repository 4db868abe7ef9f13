"""Ensembles and populations on the chunked route
(``njode_tpu_torch/utils/ensemble.py`` ``_EnsembleRun``: each epoch of all
K members one program, the port's counterpart of the JAX package's
``run_chunk``) on the CPU, where the program runs eagerly.

* Against the member loop it replaces (``train_ensemble_full(...,
  chunked=False)``): a K=2 ensemble (the shuffle and dropout on, and the
  forced gap-loop pair's plain version) and a population of 3, 5 epochs in
  chunks of 2, 2 and 1: every member row (train, validation, relative
  loss), every ``on_chunk`` call, the stack and every member's Adam state
  bitwise equal; a resume at epoch 3, inside the full run's second chunk,
  bitwise the full run's.
* The program with the host reads of a tensor patched to raise; the
  members' host-reading guards note on the device.
* Against the JAX package's ``train_ensemble_full`` (its vmapped
  ``run_chunk``) from one bridged stack on the same data (the JAX
  package's draws fed to the port's loaders), the shuffle off, one chunk
  of 2 epochs: member rows rtol 2e-5 / atol 1e-6, parameters and Adam
  moments rtol 1e-4 / atol 2e-6 (``tests/test_torch_chunked.py``'s
  limits; the atol covers relative losses near 0).
* After a chunk each member's inference reads its weights as they stand
  (a CUDA graph's replay moves them without bumping their versions, so the
  chunk drops each member's cut of them).
"""

import contextlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.simulation import simulate_batch as jax_simulate_batch
from njode_tpu.utils import ensemble as jax_ens
from njode_tpu.utils import training as jax_training
from njode_tpu_torch import NeuralJumpODE
from njode_tpu_torch.simulation import TrajectoryBatch
from njode_tpu_torch.utils import (adam_state_from_jax, ensemble_predict,
                                   ensemble_state_from_jax, make_adam)
from njode_tpu_torch.utils import ensemble as ens
from njode_tpu_torch.utils import training as T
from njode_tpu_torch.utils.chunked import EpochProgram

MODEL_KW = dict(input_dim=1, hidden_dim=8, output_dim=1, num_moments=2,
                n_hidden_layers=1)
PROC_KW = dict(n_steps=20, T=1.0, mu=0.1, sigma=0.5, x0=1.0)
TRAIN_KW = dict(n_trajectories=32, batch_size=16, obs_fraction=0.2,
                obs_only=True, moment_weights=[1.0, 10.0], n_val=8,
                **PROC_KW)
DATA = dict(process_type="black_scholes", n_train=32, obs_fraction=0.2,
            obs_only=True, **PROC_KW)
BRIDGE = dict(num_moments=2, shared_network=False, n_hidden_layers=1)
ROW_TOL = dict(rtol=2e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=2e-6)
LR, WD = 1e-3, 5e-4

CASES = {
    "ensemble": dict(model=dict(dropout_rate=0.1), n_seeds=2, share=False),
    "forced": dict(model=dict(shared_network=True, dt_ode_step=0.05,
                              use_pallas=True), n_seeds=2, share=False),
    "population": dict(model=dict(), n_seeds=3, share=True,
                       lrs=[1e-2, 1e-3, 1e-4]),
}


def run(case, chunked, n_epochs=5, start_epoch=0, initial_state=None):
    """train_ensemble_full of a case, chunks of 2, with validation and the
    relative loss: (stack, Adam states, rows, on_chunk calls)."""
    c = CASES[case]
    model = NeuralJumpODE(**MODEL_KW, **c["model"], device="cpu")
    rel = T._ensemble_rel_eval({"data": DATA, "data_seed": 0}, model,
                               c["n_seeds"], share_data=c["share"])
    kw = dict(n_seeds=c["n_seeds"], share_data=c["share"])
    if "lrs" in c:
        kw.update(optimizer=ens.population_adam(), member_hparams={
            "learning_rate": c["lrs"], "weight_decay": [WD] * len(c["lrs"])})
    calls = []

    def on_chunk(next_epoch, stack, opt_states, merged):
        calls.append((next_epoch, {k: v.clone() for k, v in merged.items()}))
    stack, opt_states, rows = ens.train_ensemble_full(
        model, "black_scholes", n_epochs=n_epochs, rel_eval=rel,
        chunk_len=2, on_chunk=on_chunk, chunked=chunked,
        start_epoch=start_epoch, initial_state=initial_state, **kw,
        **TRAIN_KW)
    return stack, opt_states, rows, calls


def assert_states_equal(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert sa["param_groups"] == sb["param_groups"]
        for i, st in sa["state"].items():
            for k, v in st.items():
                assert torch.equal(v, sb["state"][i][k]), (i, k)


def assert_runs_equal(a, b):
    stack_a, opt_a, rows_a = a[:3]
    stack_b, opt_b, rows_b = b[:3]
    assert rows_a.keys() == rows_b.keys() == {"train", "val", "rel"}
    for k in rows_a:
        assert torch.equal(rows_a[k], rows_b[k]), k
    assert stack_a.keys() == stack_b.keys()
    assert all(torch.equal(stack_a[k], stack_b[k]) for k in stack_a)
    assert_states_equal(opt_a, opt_b)


@pytest.mark.parametrize("case", list(CASES))
def test_ensemble_program_is_the_member_loop_bitwise(case):
    """Each epoch of all members one program, the rows read once a chunk:
    every member row and on_chunk call, the stack and the Adam states
    bitwise the member loop's; resumed at epoch 3 (inside the second chunk)
    from the 3-epoch run's state, the full run's last rows and state."""
    loop = run(case, False)
    prog = run(case, True)
    assert_runs_equal(prog, loop)
    assert [e for e, _ in prog[3]] == [e for e, _ in loop[3]] == [2, 4, 5]
    for (_, a), (_, b) in zip(prog[3], loop[3]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    first = run(case, True, n_epochs=3)
    resumed = run(case, True, start_epoch=3,
                  initial_state=(first[0], first[1]))
    assert [e for e, _ in resumed[3]] == [5]
    tail = tuple(prog[:2]) + ({k: v[3:] for k, v in prog[2].items()},)
    assert_runs_equal(resumed, tail)


READS = ("item", "__bool__", "__float__", "__int__", "tolist")


@contextlib.contextmanager
def host_reads_raise():
    """Tensor.item, __bool__, __float__, __int__ and tolist raise within
    the block (torch.optim's own reads of the CPU step count pass)."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def raising(name):
        def read(self, *args, **kwargs):
            caller = inspect.currentframe().f_back
            if caller.f_globals.get("__name__", "").startswith("torch.optim"):
                return saved[name](self, *args, **kwargs)
            raise AssertionError(f"a host read (Tensor.{name}) in the "
                                 "ensemble's epoch program")
        return read
    with pytest.MonkeyPatch.context() as mp:
        for name in READS:
            mp.setattr(torch.Tensor, name, raising(name))
        yield


def test_ensemble_program_reads_nothing_on_the_host(monkeypatch):
    """Every call of the ensemble's epoch program (data, each member's
    steps, validation and relative loss) with the host reads of a tensor
    raising, on the forced gap-loop pair (its substep budget guard noted on
    the device and read after each chunk)."""
    orig = EpochProgram.__call__
    runs, calls = [], []

    def call(self, again=True):
        calls.append(self.what)
        with host_reads_raise():
            return orig(self, again)
    monkeypatch.setattr(EpochProgram, "__call__", call)
    init = ens._EnsembleRun.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        runs.append(self)
    monkeypatch.setattr(ens._EnsembleRun, "__init__", spy)
    stack, _, rows, _ = run("forced", True, n_epochs=3)
    assert calls == ["ensemble epoch of 2 members"] * 3
    assert all(torch.isfinite(v).all() for v in rows.values())
    assert set(runs[0].guards._worst) == {"substep budget"}


def test_ensemble_route_says_its_mode(capsys, monkeypatch):
    """The path line of the ensemble's program: off the card "eager: not on
    a CUDA device"; a mesh and debug_checks keep their reasons."""
    run("ensemble", True, n_epochs=1)
    assert capsys.readouterr().out == ""
    model = NeuralJumpODE(**MODEL_KW, device="cpu")
    ens.train_ensemble_full(model, "black_scholes", n_seeds=2, n_epochs=1,
                            verbose=True, **TRAIN_KW)
    line = capsys.readouterr().out.strip()
    assert line == ("Training path: composed from epoch 0 (use_train_kernel="
                    "False, device cpu), an ensemble of 2 members, chunked "
                    "(eager: not on a CUDA device)")
    members = ens._members(model, ens.init_ensemble(model, 2), None,
                           lambda p: make_adam(p, LR, WD), None, [0, 1], {})
    loaders = {ds: T.DataLoader(ds, 4, "black_scholes", 0.2, False, PROC_KW,
                                device="cpu") for ds in (0, 1)}
    assert ens._ensemble_decline(members, loaders, [0, 1], None) is None
    assert ens._ensemble_decline(members, loaders, [0, 1], object()) == (
        "a mesh: each rank trains its members and joins them over the "
        "process group")
    monkeypatch.setattr(members[1].model, "debug_checks", True)
    assert ens._ensemble_decline(members, loaders, [0, 1], None) == (
        "debug_checks reads the host")


def test_a_chunk_drops_each_members_inference_weights(monkeypatch):
    """A replay moves the weights without bumping their versions: after a
    chunk, a member whose weights move so (through .data) predicts with the
    moved weights, as ensemble_predict of its state does."""
    members = []
    orig = ens._members

    def spy(*args, **kwargs):
        members.extend(orig(*args, **kwargs))
        return members
    monkeypatch.setattr(ens, "_members", spy)
    run("forced", True, n_epochs=2)
    b = T.DataLoader(0, 6, "black_scholes", 0.2, False, PROC_KW,
                     obs_only=True, device="cpu")(0)
    for tr in members:
        assert tr.model._gap_cache is None
        with torch.no_grad():
            for p in tr.model.parameters():
                p.data.mul_(1.01)
            got = tr.model.apply(b.times, b.values, b.mask)
        ref = ensemble_predict(tr.model, ens.stack_states(
            [tr.model.state_dict()]), b.times, b.values, b.mask)
        assert torch.equal(got[0], ref[0][0])
        assert torch.equal(got[1], ref[1][0])


# ----------------------------------------------------- against the JAX package

def jax_batches(n_seeds, n_epochs, n, n_val, seed=0):
    """The JAX package's draws of train_ensemble_full (its member data keys
    an epoch, its validation keys), as numpy, by the port's generator seed
    of the same (member, stream, epoch)."""
    kw = dict(obs_only=True, **PROC_KW)
    base = jax.random.PRNGKey(seed)
    port_seeds = ens._member_seeds(seed, n_seeds)
    out = {}
    for s, ds in enumerate(port_seeds):
        for e in range(n_epochs):
            key = jax.random.fold_in(jax.random.fold_in(base, e), s)
            out[T.stream_seed(ds, T.STREAM_TRAIN, e)] = jax_simulate_batch(
                key, n, "black_scholes", 0.2, **kw)
    vkeys = jax_ens._member_keys(jax.random.fold_in(base, 0xFFFFFFFF),
                                 n_seeds)
    for s, ds in enumerate(port_seeds):
        out[T.stream_seed(ds, T.STREAM_VAL, 0)] = jax_simulate_batch(
            vkeys[s], n_val, "black_scholes", 0.2, **kw)
    return {k: TrajectoryBatch(*(torch.tensor(np.array(x)) for x in (
        b.times, b.values, b.mask, b.grid_times, b.obs_idx)), None)
        for k, b in out.items()}


def test_the_ensemble_program_matches_jax(monkeypatch):
    """One chunk of 2 epochs of a K=2 ensemble, the shuffle off: the port's
    program (the JAX package's draws fed to its loaders by seed) against
    the JAX package's train_ensemble_full from the bridged stack, with the
    same relative-loss batch and true losses."""
    K, E, n, n_val = 2, 2, 32, 8
    batches = jax_batches(K, E, n, n_val)
    monkeypatch.setattr(T.DataLoader, "generate",
                        lambda self, gen: batches[gen.initial_seed()])
    jax_model = JaxModel(use_pallas=False, **MODEL_KW)
    tx = jax_training.make_adam(LR, WD)
    params = jax_ens.init_ensemble(jax_model, K, seed=3)
    model = NeuralJumpODE(**MODEL_KW, device="cpu")
    first = [batches[T.stream_seed(ds, T.STREAM_TRAIN, 0)]
             for ds in ens._member_seeds(0, K)]
    rel = {k: torch.stack([getattr(b, k)[:10] for b in first])
           for k in ("times", "values", "mask")}
    rel["l_true"] = T._rel_l_true({"data": DATA,
                                   "moment_weights": [1.0, 10.0]}, model,
                                  rel["times"], rel["values"], rel["mask"])
    kw = dict(n_seeds=K, n_epochs=E, n_trajectories=n, batch_size=16,
              obs_fraction=0.2, shuffle=False, obs_only=True,
              moment_weights=[1.0, 10.0], n_val=n_val, chunk_len=E,
              **PROC_KW)
    jp, js, jh = jax_ens.train_ensemble_full(
        jax_model, "black_scholes", optimizer=tx,
        initial_state=(params, jax.vmap(tx.init)(params)),
        rel_eval={k: jnp.asarray(v.numpy()) for k, v in rel.items()}, **kw)
    stack, opt_states, rows = ens.train_ensemble_full(
        model, "black_scholes", optimizer=lambda p: make_adam(p, LR, WD),
        initial_state=(ensemble_state_from_jax(params, **BRIDGE), None),
        rel_eval=rel, **kw)
    for k in ("train", "val", "rel"):
        np.testing.assert_allclose(rows[k].numpy(), np.asarray(jh[k]),
                                   err_msg=k, **ROW_TOL)
    ref = ensemble_state_from_jax(jp, **BRIDGE)
    for k, v in ref.items():
        np.testing.assert_allclose(stack[k].numpy(), v.numpy(), err_msg=k,
                                   **STATE_TOL)
    for s in range(K):
        m = NeuralJumpODE(**MODEL_KW, device="cpu")
        m.load_state_dict(ens.member_state(stack, s))
        want = adam_state_from_jax(js, m, lr=LR, weight_decay=WD,
                                   member=s)["state"]
        for i, st in want.items():
            for name in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(
                    opt_states[s]["state"][i][name].numpy(),
                    st[name].numpy(), err_msg=f"member {s} {i} {name}",
                    **STATE_TOL)


def test_chip_smoke_phase_53_runs_phase_38s_and_33s_configs():
    """chip_smoke.py phase 53's windows: phase 38's three ensemble runs
    (the forced production K=4 ensemble, the default recipe's population
    of three rates, the scaled K=2 ensemble) and phase 33's scaled d=2
    recipes of both registered families, each cut to 2 chunks of 2
    epochs."""
    import chip_smoke as cs
    ens_cfg = cs.ensemble_configs()
    assert set(ens_cfg) == set(cs.ENSEMBLE_ROWS)
    forced = ens_cfg["ens-production-forced"]
    assert forced == {**cs.ens_forced_config(cs.ENS_K, 4, "ens53"),
                      "print_every": 2}
    assert forced["use_pallas"] is True and forced["ensemble"] == 4
    pop = ens_cfg["population-default"]
    assert pop["ensemble_lrs"] == [1e-2, 1e-3, 1e-4]
    assert pop["hidden_dim"] == 32 and pop["use_pallas"] == "auto"
    scaled = ens_cfg["ens-scaled"]
    assert scaled["ensemble"] == 2 and scaled["use_pallas"] == "step"
    assert scaled["hidden_dim"] == 256 and scaled["batch_size"] == 4096
    reg = cs.registered_configs()
    assert [c["data"]["process_type"] for c in reg.values()] == list(
        cs.FAMILIES_ND)
    for c in (*ens_cfg.values(), *reg.values()):
        assert c["print_every"] == 2
    for process, c in zip(cs.FAMILIES_ND, reg.values()):
        ref = cs.family_config("scaled", 4, "chunked", process)
        assert c == {**ref, "print_every": 2}
        assert c["data"]["dims"] == 2 and c["data"]["obs_only"] is True
