"""The Trainer's chunked route (``Trainer.train(..., chunk_epochs=...)``,
``njode_tpu_torch/utils/training.py``) on the CPU.

* Against the JAX package's chunked Trainer (``_train_chunked``): the
  composed route, the run twin and the walk twin (the kernels' plain
  versions here, JAX's Pallas kernels in interpret mode), the per-gap rk4
  loop and the plain grid walk (``use_pallas=False`` on both sides), from
  bridged weights, on cached ``DataLoader``s of both packages that hold the
  same numpy batch, shuffle off, ``print_every`` 3 and 7 epochs (chunks of
  3, 3 and 1).  Tolerances are ``tests/test_torch_training.py``'s: per-epoch
  losses rtol 2e-5, parameters and Adam moments rtol 1e-4 / atol 2e-6.
  Checkpoints fall at the epochs JAX writes them, also after a resume at
  epoch 4.
* Against the port's own per-epoch loop (``chunk_epochs=0``) on fresh data
  with the shuffle on (and dropout): every loss and the final state
  bitwise equal, on every route the card captures (the forced kernels'
  plain versions here).
* One chunk's device programs with the host reads of a tensor patched to
  raise, which routes the card captures (``Trainer._graph_decline``), the
  ``chunk_epochs`` values, the per-epoch fallback for data callables, the
  non-finite warning.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.utils.training import Trainer as JaxTrainer
from njode_tpu.utils.training import create_data_loaders as jax_loaders
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.simulation import TrajectoryBatch
from njode_tpu_torch.utils import (DataLoader, Trainer, adam_state_from_jax,
                                   create_data_loaders, make_adam,
                                   state_dict_from_jax)
from njode_tpu_torch.utils import training as T

LOSS_TOL = dict(rtol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=2e-6)
LR, WD = 1e-3, 5e-4
H, NT, NV, BS, PRINT = 8, 20, 6, 8, 3
BS_KW = dict(mu=0.1, sigma=0.5, x0=1.0)
# the composed route and the run twin on the 100-step grid, the walk twin
# on a 20-step grid at dt_ode_step 0.05 (every observation on its grid)
ROUTES = {
    "composed": dict(model=dict(), kernel=False, n_steps=100,
                     obs_fraction=0.05),
    "run": dict(model=dict(), kernel=True, n_steps=100, obs_fraction=0.05),
    "walk": dict(model=dict(shared_network=True, dt_ode_step=0.05,
                            t_max=1.0, grid_walk=True),
                 kernel=True, n_steps=20, obs_fraction=0.25, bs=16),
    # the rk4 recipe's route (its grid off dt_ode_step's) and the plain
    # grid walk of two networks, no kernel on either side
    "per-gap-rk4": dict(model=dict(shared_network=True, dt_ode_step=0.05,
                                   ode_solver="rk4", use_pallas=False),
                        kernel=False, n_steps=100, obs_fraction=0.05),
    "grid-walk": dict(model=dict(dt_ode_step=0.05, t_max=1.0,
                                 grid_walk=True, use_pallas=False),
                      kernel=False, n_steps=20, obs_fraction=0.25),
}


def config(route):
    return {"data": {"process_type": "black_scholes", **BS_KW}}


def loaders(route):
    """JAX's cached loaders and the port's, holding the same batches."""
    r = ROUTES[route]
    j_train, j_val = jax_loaders(
        process_type="black_scholes", n_train=NT, n_val=NV,
        obs_fraction=r["obs_fraction"], n_steps=r["n_steps"],
        cache_data=True, base_seed=0, obs_only=True, **BS_KW)
    ours = []
    for j, stream in ((j_train, T.STREAM_TRAIN), (j_val, T.STREAM_VAL)):
        b = j(0)
        loader = DataLoader(0, j.n_trajectories, "black_scholes",
                            r["obs_fraction"], True,
                            dict(n_steps=r["n_steps"], **BS_KW),
                            obs_only=True, stream=stream, device="cpu")
        loader._cached = TrajectoryBatch(
            torch.tensor(np.array(b.times)),
            torch.tensor(np.array(b.values)),
            torch.tensor(np.array(b.mask)),
            torch.tensor(np.array(b.grid_times)),
            torch.tensor(np.array(b.obs_idx)), None)
        ours.append(loader)
    return (j_train, j_val), tuple(ours)


def jax_trainer(route):
    r = ROUTES[route]
    model = JaxModel(input_dim=1, hidden_dim=H, output_dim=1, num_moments=2,
                     **{"use_pallas": False, **r["model"]})
    kw = {}
    if r["kernel"]:
        kw = dict(use_train_kernel="interpret",
                  train_kernel_opts=dict(lr=LR, weight_decay=WD))
    return JaxTrainer(model, jax_make_adam(LR, WD),
                      ignore_first_continuity=True,
                      moment_weights=[1.0, 10.0], seed=5, **kw)


def bridge(route, params):
    return dict(num_moments=2, n_hidden_layers=1,
                shared_network=ROUTES[route]["model"].get("shared_network",
                                                          False))


def port_trainer(route, params, opt_state=None):
    r = ROUTES[route]
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu",
                          **r["model"])
    model.load_state_dict(state_dict_from_jax(params, **bridge(route,
                                                              params)))
    opt = make_adam(model.parameters(), LR, WD)
    if opt_state is not None:
        opt.load_state_dict(adam_state_from_jax(opt_state, model, lr=LR,
                                                weight_decay=WD))
    return Trainer(model, opt, ignore_first_continuity=True,
                   moment_weights=[1.0, 10.0], seed=5,
                   use_train_kernel=r["kernel"])


def record_saves(trainer):
    """The train-loss count at every save_model call."""
    saves = []
    orig = trainer.save_model

    def save(path):
        saves.append(len(trainer.train_losses))
        orig(path)
    trainer.save_model = save
    return saves


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_state_close(route, trainer, params, opt_state):
    ref = state_dict_from_jax(params, **bridge(route, params))
    sd = trainer.model.state_dict()
    for key, val in ref.items():
        np.testing.assert_allclose(sd[key].numpy(), val.numpy(), err_msg=key,
                                   **STATE_TOL)
    ref_opt = adam_state_from_jax(opt_state, trainer.model, lr=LR,
                                  weight_decay=WD)["state"]
    ours = trainer.optimizer.state_dict()["state"]
    for i, s in ref_opt.items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(ours[i][k].numpy(), s[k].numpy(),
                                       err_msg=f"{i} {k}", **STATE_TOL)
        assert float(ours[i]["step"]) == float(s["step"])


@pytest.mark.parametrize("route", list(ROUTES))
def test_chunked_trainer_matches_jax(route, tmp_path):
    """7 epochs in chunks of 3, 3 and 1: per-epoch train, validation and
    relative losses, the final parameters and Adam moments, and the epochs
    at which each writes its checkpoint."""
    (jt, jv), (pt, pv) = loaders(route)
    jtr = jax_trainer(route)
    init = host(jtr.params)
    jsaves = record_saves(jtr)
    bs = ROUTES[route].get("bs", BS)
    ref = jtr.train(jt, jv, n_epochs=7, batch_size=bs, shuffle=False,
                    print_every=PRINT, save_path=str(tmp_path / "jax.ckpt"),
                    config=config(route))
    trainer = port_trainer(route, init)
    saves = record_saves(trainer)
    hist = trainer.train(pt, pv, n_epochs=7, batch_size=bs, shuffle=False,
                         print_every=PRINT,
                         save_path=str(tmp_path / "port.ckpt"),
                         config=config(route))
    for k in ("train_loss", "val_loss", "relative_loss"):
        assert len(hist[k]) == len(ref[k]), k
        np.testing.assert_allclose(hist[k], ref[k], err_msg=k, **LOSS_TOL)
    assert_state_close(route, trainer, host(jtr.params),
                       host(jtr.opt_state))
    assert saves == jsaves == [3, 6, 7, 7]


def test_chunked_resume_realigns_as_jax(tmp_path, capsys):
    """A run of 4 epochs resumed to 7: the first chunk ends on the print
    boundary (epochs 4-5), then 6; the same checkpoints, losses and
    "(resumed)" line as JAX's."""
    route = "composed"
    (jt, jv), (pt, pv) = loaders(route)
    jtr = jax_trainer(route)
    init = host(jtr.params)
    kw = dict(batch_size=BS, shuffle=False, print_every=PRINT,
              config=config(route))
    jtr.train(jt, jv, n_epochs=4, save_path=str(tmp_path / "jax.ckpt"),
              **kw)
    first = port_trainer(route, init)
    first.train(pt, pv, n_epochs=4, save_path=str(tmp_path / "port.ckpt"),
                **kw)
    capsys.readouterr()
    jres = jax_trainer(route)
    jsaves = record_saves(jres)
    ref = jres.train(jt, jv, n_epochs=7,
                     save_path=str(tmp_path / "jax.ckpt"), **kw)
    jout = capsys.readouterr().out
    resumed = port_trainer(route, init)
    saves = record_saves(resumed)
    hist = resumed.train(pt, pv, n_epochs=7,
                         save_path=str(tmp_path / "port.ckpt"), **kw)
    out = capsys.readouterr().out
    assert saves == jsaves == [6, 7, 7]
    for k in ("train_loss", "val_loss", "relative_loss"):
        np.testing.assert_allclose(hist[k], ref[k], err_msg=k, **LOSS_TOL)

    def epochs(text):
        return [line.split("|")[0].strip() + (" (resumed)" * line.endswith(
            "(resumed)")) for line in text.splitlines()
            if line.startswith("Epoch ")]
    assert epochs(out) == epochs(jout) == ["Epoch    4 (resumed)",
                                           "Epoch    6"]


# ----------------------------------------------------------------------
# against the port's per-epoch loop
# ----------------------------------------------------------------------

FRESH = {
    "composed": dict(model=dict(dropout_rate=0.1), kernel=False, n_steps=100,
                     obs_fraction=0.05),
    "run": ROUTES["run"],
    "walk": ROUTES["walk"],
    # the routes the card captures since the whole-run kernels and the
    # single-step composed route: the per-gap rk4 loop (with dropout), the
    # forced gap-loop pair (rows 2-5), the grid walk of two networks on the
    # walk kernels' plain version (rows 7-8), the forced fused Euler cell
    # (row 6)
    "per-gap-rk4": dict(model=dict(shared_network=True, dt_ode_step=0.05,
                                   ode_solver="rk4", dropout_rate=0.1),
                        kernel=False, n_steps=100, obs_fraction=0.05),
    "forced-pair": dict(model=dict(shared_network=True, dt_ode_step=0.05,
                                   t_max=1.0, use_pallas=True),
                        kernel=False, n_steps=20, obs_fraction=0.25),
    "grid-walk": dict(model=dict(dt_ode_step=0.05, t_max=1.0, grid_walk=True),
                      kernel=False, n_steps=20, obs_fraction=0.25),
    "forced-cell": dict(model=dict(use_pallas=True), kernel=False,
                        n_steps=100, obs_fraction=0.05),
}
# the guards each route notes on the device in a chunk
GUARDS = {"composed": set(), "run": {"padded slots"},
          "walk": {"grid alignment", "substep budget", "padded slots"},
          "per-gap-rk4": {"substep budget"},
          "forced-pair": {"substep budget"},
          "grid-walk": {"grid alignment", "substep budget"},
          "forced-cell": set()}


def fresh_run(route, chunk_epochs, n_epochs=5, print_every=2):
    """A run on fresh obs-only data with the shuffle on, from fixed
    weights: (history, model state, optimizer state, output path line)."""
    r = FRESH[route]
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu",
                          generator=torch.Generator().manual_seed(4),
                          **r["model"])
    trainer = Trainer(model, make_adam(model.parameters(), LR, WD),
                      ignore_first_continuity=True,
                      moment_weights=[1.0, 10.0], seed=7,
                      use_train_kernel=r["kernel"])
    train, val = create_data_loaders(
        "black_scholes", n_train=NT, n_val=NV, obs_fraction=r["obs_fraction"],
        cache_data=False, base_seed=2, obs_only=True, device="cpu",
        n_steps=r["n_steps"], **BS_KW)
    hist = trainer.train(train, val, n_epochs=n_epochs, batch_size=BS,
                         print_every=print_every, config=config(route),
                         chunk_epochs=chunk_epochs)
    return hist, trainer


@pytest.mark.parametrize("route", list(FRESH))
def test_chunked_route_is_the_per_epoch_loop_bitwise(route):
    """Fresh data each epoch, the shuffle on (dropout on the composed
    route): the chunks' generators, reseeded from stream_seed before every
    epoch, draw what the per-epoch loop's fresh generators draw; the
    whole-run kernels' state stays in the kernel's layout through a chunk
    and its Adam powers come from the step count each epoch, as the
    per-epoch conversion makes them.  Losses and state bitwise equal."""
    eager, te = fresh_run(route, 0)
    chunked, tc = fresh_run(route, "auto")
    for k in ("train_loss", "val_loss", "relative_loss"):
        assert chunked[k] == eager[k], k
    for a, b in ((te.model.state_dict(), tc.model.state_dict()),):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    oe, oc = (t.optimizer.state_dict()["state"] for t in (te, tc))
    assert all(torch.equal(oe[i][k], oc[i][k]) for i in oe for k in oe[i])
    assert te._chunk_run is None and tc._chunk_run is not None


# ----------------------------------------------------------------------
# the chunk's programs read nothing on the host
# ----------------------------------------------------------------------

def _raise_on_host_read(name):
    def read(self, *args, **kwargs):
        # Adam on the CPU keeps its step count on the host (torch.optim's
        # _get_value); make_adam builds it capturable on the card
        caller = inspect.currentframe().f_back
        if caller.f_globals.get("__name__", "").startswith("torch.optim"):
            return getattr(torch.Tensor, f"_chunk_{name}")(self, *args,
                                                           **kwargs)
        raise AssertionError(f"a host read (Tensor.{name}) in a chunk")
    return read


@pytest.mark.parametrize("route", list(FRESH))
def test_chunk_programs_read_nothing_on_the_host(route, monkeypatch):
    """One chunk of 3 epochs through its programs (the epoch's data,
    shuffle, packing, training and validation; the relative loss), as the
    card captures them, with Tensor.item, __bool__, __float__, __int__ and
    tolist raising: the guards note on the device and are read after the
    chunk."""
    r = FRESH[route]
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu",
                          generator=torch.Generator().manual_seed(4),
                          **r["model"])
    trainer = Trainer(model, make_adam(model.parameters(), LR, WD),
                      ignore_first_continuity=True,
                      moment_weights=[1.0, 10.0], seed=7,
                      use_train_kernel=r["kernel"])
    train, val = create_data_loaders(
        "black_scholes", n_train=NT, n_val=NV, obs_fraction=r["obs_fraction"],
        cache_data=False, base_seed=2, obs_only=True, device="cpu",
        n_steps=r["n_steps"], **BS_KW)
    rel = trainer._setup_relative_loss(train, config(route))
    first = train(0)
    run = T._ChunkRun(trainer, train, val, rel, BS, True, r["kernel"],
                      capture=False, defer=True,
                      n_slots=first.times.shape[1])
    run.begin()
    names = ("item", "__bool__", "__float__", "__int__", "tolist")
    for name in names:
        monkeypatch.setattr(torch.Tensor, f"_chunk_{name}",
                            getattr(torch.Tensor, name), raising=False)
        monkeypatch.setattr(torch.Tensor, name, _raise_on_host_read(name))
    out = []
    for epoch in range(3):
        run.streams.seed(epoch)
        out.append(run.epoch())
        out.append(run.relative())
    for name in names:
        monkeypatch.setattr(torch.Tensor, name,
                            getattr(torch.Tensor, f"_chunk_{name}"))
    run.end(3)
    run.guards.check()
    assert all(bool(torch.isfinite(x)) for group in out for x in group)
    if route in GUARDS:
        assert set(run.guards._worst) == GUARDS[route]


# ----------------------------------------------------------------------
# which routes the card captures
# ----------------------------------------------------------------------

# each route's training path as the Trainer's "Training path:" line names
# it, and the forced kernels it runs
ROUTE_OF = {"composed": ("composed", None),
            "run": ("whole-run kernel", None),
            "walk": ("walk-train kernel", None),
            "per-gap-rk4": ("composed (per-gap rk4 loop)", None),
            "forced-pair": ("composed (forced gap-loop kernels)",
                            "gap-loop kernels"),
            "grid-walk": ("composed", None),
            "forced-cell": ("composed (forced fused Euler cell)",
                            "fused Euler cell")}
EAGER = {
    "mesh": "a mesh: every step's collectives run through the process group",
    # captured, its draw under a sync check
    # (tests/test_torch_chunked_registered.py)
    "registered process": None,
    "loader elsewhere": "the loader's device is not the model's",
    "debug_checks": "debug_checks reads the host",
    "host Adam": "the optimizer is not capturable (make_adam builds "
                 "torch.optim.Adam with capturable=True on the card)",
}


def decline_case(route, capsys):
    """A trainer of a FRESH route, its training loader, and the path line
    of one epoch's chunk."""
    r = FRESH[route]
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu",
                          **r["model"])
    trainer = Trainer(model, make_adam(model.parameters(), LR, WD),
                      ignore_first_continuity=True,
                      use_train_kernel=r["kernel"])
    train, _ = create_data_loaders(
        "black_scholes", n_train=4, n_val=2, obs_fraction=r["obs_fraction"],
        obs_only=True, device="cpu", n_steps=r["n_steps"], **BS_KW)
    capsys.readouterr()
    trainer.train(train, n_epochs=1, batch_size=4, print_every=1)
    line = next(x for x in capsys.readouterr().out.splitlines()
                if x.startswith("Training path:"))
    return trainer, train, line


@pytest.mark.parametrize("route", list(FRESH))
def test_graph_decline_takes_every_single_device_route(route, capsys):
    """Every single-device route of a DataLoader is captured on the card:
    the whole-run kernels, the composed route, the per-gap loops, the
    forced gap-loop pair, the grid walk and the forced fused Euler cell
    (here, off the card, its chunks run the same programs eagerly)."""
    trainer, train, line = decline_case(route, capsys)
    path, forced = ROUTE_OF[route]
    assert line.startswith(f"Training path: {path} from epoch 0")
    assert line.endswith(", chunked (eager: not on a CUDA device)")
    m = trainer.model
    assert m._forced_route() == forced
    assert m._walks() == (route in ("walk", "grid-walk"))
    assert trainer._graph_decline(FRESH[route]["kernel"], train) is None


@pytest.mark.parametrize("case", list(EAGER))
def test_graph_decline_keeps_its_reasons(case, capsys, monkeypatch):
    """The routes the card still runs eagerly, each with its reason: a
    mesh, a loader on another device, debug_checks, an optimizer that is
    not capturable (on the card); a registered process's generator (a
    d-dimensional family) no longer declines: its draws are captured."""
    trainer, train, _ = decline_case("per-gap-rk4", capsys)
    if case == "mesh":
        monkeypatch.setattr(trainer, "mesh", object())
    elif case == "registered process":
        train = DataLoader(0, 4, "black_scholes_nd", 0.1, True, {},
                           device="cpu")
    elif case == "loader elsewhere":
        monkeypatch.setattr(train, "device", torch.device("meta"))
    elif case == "debug_checks":
        monkeypatch.setattr(trainer.model, "debug_checks", True)
    else:
        # what the card sees of a torch.optim.Adam built with its defaults
        cuda = torch.device("cuda", 0)
        monkeypatch.setattr(trainer, "device", cuda)
        monkeypatch.setattr(train, "device", cuda)
        for g in trainer.optimizer.param_groups:
            monkeypatch.setitem(g, "capturable", False)
    assert trainer._graph_decline(False, train) == EAGER[case]


def test_a_loader_on_the_current_card_is_the_models(capsys, monkeypatch):
    """run_experiment's loaders name the card "cuda" (the default device),
    the model's parameters "cuda:0": one device while card 0 is current,
    so the route is captured; another current card declines."""
    trainer, train, _ = decline_case("per-gap-rk4", capsys)
    monkeypatch.setattr(trainer, "device", torch.device("cuda", 0))
    monkeypatch.setattr(train, "device", torch.device("cuda"))
    for g in trainer.optimizer.param_groups:
        monkeypatch.setitem(g, "capturable", True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert trainer._graph_decline(False, train) is None
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert (trainer._graph_decline(False, train)
            == EAGER["loader elsewhere"])


def test_deferred_guard_raises_after_the_chunk():
    """A batch off the walk twin's grid: the guard notes it on the device
    and the chunk raises the model's own error after its epochs."""
    r = ROUTES["walk"]
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu", **r["model"])
    trainer = Trainer(model, ignore_first_continuity=True,
                      use_train_kernel=True)
    (_, _), (train, _) = loaders("walk")
    b = train._cached
    train._cached = TrajectoryBatch(b.times + 0.01, b.values, b.mask,
                                    b.grid_times, b.obs_idx, None)
    with pytest.raises(ValueError, match="not multiples of dt_ode_step"):
        trainer.train(train, n_epochs=2, batch_size=BS, shuffle=False)
    assert trainer.train_losses == []


# ----------------------------------------------------------------------
# a program is captured only where a later call replays it
# ----------------------------------------------------------------------

def test_a_program_no_later_call_replays_is_not_captured(monkeypatch):
    """A first call that no later call follows runs the body eagerly and
    captures nothing; a first call that one follows warms up and
    captures, and later calls replay."""
    from types import SimpleNamespace
    from njode_tpu_torch.utils.chunked import EpochProgram
    seen = []
    prog = EpochProgram(lambda: seen.append("body") or ("eager",),
                        capture=True)

    def capture():
        seen.append("capture")
        prog.graph = SimpleNamespace(replay=lambda: seen.append("replay"))
        prog.out = ("replayed",)
    monkeypatch.setattr(prog, "_warm_up",
                        lambda: seen.append("warm-up") or ("warm",))
    monkeypatch.setattr(prog, "_capture", capture)
    assert prog(again=False) == ("eager",)
    assert prog.graph is None
    assert prog() == ("warm",)
    assert prog(again=False) == ("replayed",)
    assert seen == ["body", "warm-up", "capture", "replay"]
    assert prog.replays == 1


def test_the_runs_last_calls_say_no_replay_follows(monkeypatch, tmp_path):
    """Through train(): the epoch program is told a later call follows at
    every epoch but the run's last, the relative loss's at every print
    epoch but the last (3 epochs, print_every 2: prints at 0 and 2),
    also after a resume."""
    from njode_tpu_torch.utils.chunked import EpochProgram
    calls = []
    orig = EpochProgram.__call__

    def call(self, again=True):
        calls.append((self.what, again))
        return orig(self, again)
    monkeypatch.setattr(EpochProgram, "__call__", call)
    (_, _), (pt, pv) = loaders("composed")
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu")
    trainer = Trainer(model, ignore_first_continuity=True)
    kw = dict(batch_size=BS, print_every=2, config=config("composed"),
              save_path=str(tmp_path / "port.ckpt"))
    trainer.train(pt, pv, n_epochs=3, **kw)
    assert calls == [("epoch", True), ("relative loss", True),
                     ("epoch", True), ("epoch", False),
                     ("relative loss", False)]
    calls.clear()
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu")
    Trainer(model, ignore_first_continuity=True).train(pt, pv, n_epochs=4,
                                                       **kw)
    assert calls == [("epoch", False)]


# ----------------------------------------------------------------------
# chunk_epochs, the fallback, the warning
# ----------------------------------------------------------------------

def chunks_of(monkeypatch):
    """The (first epoch, length) of every chunk run."""
    seen = []
    orig = T._ChunkRun.chunk

    def chunk(self, epoch, L, print_every):
        seen.append((epoch, L))
        return orig(self, epoch, L, print_every)
    monkeypatch.setattr(T._ChunkRun, "chunk", chunk)
    return seen


@pytest.mark.parametrize("chunk_epochs,want", [
    ("auto", [(0, 3), (3, 3), (6, 1)]),
    (2, [(0, 2), (2, 1), (3, 2), (5, 1), (6, 1)]),
    (5, [(0, 3), (3, 3), (6, 1)]),
    (0, []), (False, []), (None, []),
])
def test_chunk_epochs_values(chunk_epochs, want, monkeypatch, capsys):
    """"auto" chunks of print_every epochs, an int chunks of that many, cut
    at print boundaries; 0, False and None the per-epoch loop."""
    seen = chunks_of(monkeypatch)
    (_, _), (pt, pv) = loaders("composed")
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu")
    trainer = Trainer(model, ignore_first_continuity=True)
    hist = trainer.train(pt, pv, n_epochs=7, batch_size=BS,
                         print_every=PRINT, chunk_epochs=chunk_epochs)
    assert seen == want
    assert len(hist["train_loss"]) == len(hist["val_loss"]) == 7
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("Training path:")]
    assert len(line) == 1
    assert line[0].endswith(", chunked (eager: not on a CUDA device)") \
        == bool(want)


def test_data_callables_take_the_per_epoch_loop(monkeypatch):
    """As in the JAX package, a callable that is not a DataLoader (for the
    training or the validation data) takes the per-epoch loop."""
    seen = chunks_of(monkeypatch)
    (_, _), (pt, pv) = loaders("composed")
    b = pv(0)
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu")
    trainer = Trainer(model, ignore_first_continuity=True)
    trainer.train(pt, lambda: (b.times, b.values), n_epochs=2,
                  batch_size=BS)
    trainer.train(lambda: (b.times, b.values), n_epochs=1, batch_size=BS)
    assert seen == []
    trainer.train(pt, n_epochs=1, batch_size=BS)
    assert seen == [(0, 1)]


def test_non_finite_warning_names_the_epoch(monkeypatch, capsys):
    """A NaN in a chunk's losses prints JAX's warning with its epoch."""
    orig = T._ChunkRun.chunk

    def chunk(self, epoch, L, print_every):
        tr, vl, rl = orig(self, epoch, L, print_every)
        tr = [float("nan") if epoch + i == 4 else x for i, x in enumerate(tr)]
        return tr, vl, rl
    monkeypatch.setattr(T._ChunkRun, "chunk", chunk)
    (_, _), (pt, pv) = loaders("composed")
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu")
    Trainer(model, ignore_first_continuity=True).train(
        pt, pv, n_epochs=7, batch_size=BS, print_every=PRINT)
    out = capsys.readouterr().out
    assert out.count("Warning: non-finite training loss at epoch 4 — try a "
                     "lower learning rate") == 1
