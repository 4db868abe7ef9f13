"""The chunked route on registered processes (``black_scholes_nd`` and
``ornstein_uhlenbeck_nd``, registered at import by
``njode_tpu_torch/simulation/multidim.py``) on the CPU, at d_x 2.

* Against the JAX package's chunked Trainer (``_train_chunked``, whose
  ``traced_gen`` traces registered generators too) on cached
  ``black_scholes_nd`` data, from bridged weights, 4 epochs in chunks of
  2: ``tests/test_torch_chunked.py``'s limits and width (hidden 8; losses
  rtol 2e-5, parameters and Adam moments rtol 1e-4 / atol 2e-6).
* Fresh draws of both families inside the chunk, from the grid and from
  the obs-only samplers, bitwise equal to the per-epoch loop
  (``chunk_epochs=0``).
* The chunk's programs with the host reads of a tensor patched to raise.
* A registered generator that reads the host raises an error naming the
  process where the draw is captured; the families' own draws pass the
  same check.
"""

import contextlib
import inspect

import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.utils.training import Trainer as JaxTrainer
from njode_tpu.utils.training import create_data_loaders as jax_loaders
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.simulation import TrajectoryBatch, registry
from njode_tpu_torch.utils import (DataLoader, Trainer, adam_state_from_jax,
                                   create_data_loaders, make_adam,
                                   state_dict_from_jax)
from njode_tpu_torch.utils import chunked
from njode_tpu_torch.utils import training as T

LOSS_TOL = dict(rtol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=2e-6)
LR, WD = 1e-3, 5e-4
H, NT, NV, BS, D = 8, 24, 8, 8, 2
FAMILIES = {"black_scholes_nd": dict(mu=0.1, sigma=0.5),
            "ornstein_uhlenbeck_nd": dict(theta=1.0, mu=0.5, sigma=0.3)}
BRIDGE = dict(num_moments=2, n_hidden_layers=1, shared_network=False)


def process_kwargs(process):
    return dict(dims=D, n_steps=20, **FAMILIES[process])


def config(process):
    return {"data": {"process_type": process, **process_kwargs(process)}}


def port_model(seed=4):
    return NeuralJumpODE(D, H, D, num_moments=2, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def port_trainer(model):
    return Trainer(model, make_adam(model.parameters(), LR, WD),
                   ignore_first_continuity=True, moment_weights=[1.0, 10.0],
                   seed=5)


def test_chunked_trainer_matches_jax_on_black_scholes_nd():
    """JAX's chunked Trainer and the port's on one cached numpy batch of
    black_scholes_nd (obs-only, d 2), shuffle off, print_every 2 over 4
    epochs: per-epoch train, validation and relative losses, the final
    parameters and Adam moments."""
    process = "black_scholes_nd"
    jt, jv = jax_loaders(process_type=process, n_train=NT, n_val=NV,
                         obs_fraction=0.25, cache_data=True, base_seed=0,
                         obs_only=True, **process_kwargs(process))
    ours = []
    for j, stream in ((jt, T.STREAM_TRAIN), (jv, T.STREAM_VAL)):
        b = j(0)
        loader = DataLoader(0, j.n_trajectories, process, 0.25, True,
                            process_kwargs(process), obs_only=True,
                            stream=stream, device="cpu")
        loader._cached = TrajectoryBatch(
            *(torch.tensor(np.array(x)) for x in (
                b.times, b.values, b.mask, b.grid_times, b.obs_idx)), None)
        ours.append(loader)
    jtr = JaxTrainer(JaxModel(input_dim=D, hidden_dim=H, output_dim=D,
                              num_moments=2, use_pallas=False),
                     jax_make_adam(LR, WD), ignore_first_continuity=True,
                     moment_weights=[1.0, 10.0], seed=5)
    init = jax_tree(jtr.params)
    kw = dict(n_epochs=4, batch_size=BS, shuffle=False, print_every=2,
              config=config(process))
    ref = jtr.train(jt, jv, **kw)
    model = port_model()
    model.load_state_dict(state_dict_from_jax(init, **BRIDGE))
    trainer = port_trainer(model)
    assert trainer._graph_decline(False, ours[0]) is None
    hist = trainer.train(*ours, **kw)
    for k in ("train_loss", "val_loss", "relative_loss"):
        assert len(hist[k]) == len(ref[k]), k
        np.testing.assert_allclose(hist[k], ref[k], err_msg=k, **LOSS_TOL)
    params, opt_state = jax_tree(jtr.params), jax_tree(jtr.opt_state)
    sd = trainer.model.state_dict()
    for key, val in state_dict_from_jax(params, **BRIDGE).items():
        np.testing.assert_allclose(sd[key].numpy(), val.numpy(), err_msg=key,
                                   **STATE_TOL)
    ref_opt = adam_state_from_jax(opt_state, trainer.model, lr=LR,
                                  weight_decay=WD)["state"]
    got = trainer.optimizer.state_dict()["state"]
    for i, s in ref_opt.items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got[i][k].numpy(), s[k].numpy(),
                                       err_msg=f"{i} {k}", **STATE_TOL)
        assert float(got[i]["step"]) == float(s["step"])


def jax_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def fresh_run(process, obs_only, chunk_epochs):
    """5 epochs on fresh data of a family, the shuffle on, print_every 2:
    (history, trainer)."""
    trainer = port_trainer(port_model())
    train, val = create_data_loaders(
        process, n_train=NT, n_val=NV, obs_fraction=0.25, cache_data=False,
        base_seed=2, obs_only=obs_only, device="cpu",
        **process_kwargs(process))
    hist = trainer.train(train, val, n_epochs=5, batch_size=BS,
                         print_every=2, config=config(process),
                         chunk_epochs=chunk_epochs)
    return hist, trainer


@pytest.mark.parametrize("obs_only", [True, False], ids=["obs-only", "grid"])
@pytest.mark.parametrize("process", list(FAMILIES))
def test_registered_draws_in_the_chunk_are_the_per_epoch_loops(process,
                                                               obs_only):
    """Each epoch's draw comes from the registered generator (the grid
    paths, or the obs-only sampler) with the chunk's generator reseeded by
    stream_seed: every loss and the final state bitwise the per-epoch
    loop's."""
    eager, te = fresh_run(process, obs_only, 0)
    chunked_, tc = fresh_run(process, obs_only, "auto")
    for k in ("train_loss", "val_loss", "relative_loss"):
        assert chunked_[k] == eager[k], k
    a, b = te.model.state_dict(), tc.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oe, oc = (t.optimizer.state_dict()["state"] for t in (te, tc))
    assert all(torch.equal(oe[i][k], oc[i][k]) for i in oe for k in oe[i])
    assert te._chunk_run is None and tc._chunk_run is not None


READS = ("item", "__bool__", "__float__", "__int__", "tolist")


@contextlib.contextmanager
def host_reads_raise(monkeypatch, error=AssertionError,
                     text="a host read (Tensor.{}) in a chunk"):
    """Tensor.item, __bool__, __float__, __int__ and tolist raise within
    the block (torch.optim's own reads of the CPU step count pass)."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def raising(name):
        def read(self, *args, **kwargs):
            caller = inspect.currentframe().f_back
            if caller.f_globals.get("__name__", "").startswith("torch.optim"):
                return saved[name](self, *args, **kwargs)
            raise error(text.format(name))
        return read
    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, raising(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            monkeypatch.setattr(torch.Tensor, name, fn)


def chunk_run(process, obs_only=True):
    """A chunk's programs on fresh data of a family, with validation and
    the relative loss, uncaptured."""
    trainer = port_trainer(port_model())
    train, val = create_data_loaders(
        process, n_train=NT, n_val=NV, obs_fraction=0.25, cache_data=False,
        base_seed=2, obs_only=obs_only, device="cpu",
        **process_kwargs(process))
    rel = trainer._setup_relative_loss(train, config(process))
    return T._ChunkRun(trainer, train, val, rel, BS, True, False,
                       capture=False, defer=True,
                       n_slots=train(0).times.shape[1])


@pytest.mark.parametrize("process", list(FAMILIES))
def test_registered_programs_read_nothing_on_the_host(process, monkeypatch):
    """One chunk of 3 epochs through its programs (the family's obs-only
    draw, shuffle, training, validation; the relative loss), as the card
    captures them, with the host reads of a tensor raising."""
    run = chunk_run(process)
    run.begin()
    out = []
    with host_reads_raise(monkeypatch):
        for epoch in range(3):
            run.streams.seed(epoch)
            out.append(run.epoch())
            out.append(run.relative())
    run.end(3)
    run.guards.check()
    assert all(bool(torch.isfinite(x)) for group in out for x in group)


@contextlib.contextmanager
def sync_mode_on_the_cpu(mode):
    """What set_sync_debug_mode("error") makes of a host read of a CUDA
    tensor, for the CPU's tensors: a RuntimeError with torch's words."""
    with pytest.MonkeyPatch.context() as mp, host_reads_raise(
            mp, RuntimeError, "called a synchronizing CUDA operation "
            "(Tensor.{})"):
        yield


HOST_READING = "host_reading_gbm"


@pytest.fixture
def host_reading_process():
    """A registered process whose generator reads a draw to the host."""
    def paths(n_paths, *, generator, device=None, T=1.0, n_steps=20):
        vol = float(torch.rand((), generator=generator, device=device))
        z = torch.randn(n_paths, n_steps, generator=generator, device=device)
        x = torch.exp(torch.cumsum(vol * 0.1 * z, dim=1))
        return (torch.linspace(0.0, T, n_steps + 1, device=device),
                torch.cat([torch.ones(n_paths, 1, device=device), x], 1))
    registry.register_process(HOST_READING, paths)
    yield HOST_READING
    for table in (registry._PATHS, registry._MOMENTS, registry._OBS_VALUES):
        table.pop(HOST_READING, None)


def test_a_host_reading_registered_generator_raises_its_named_error(
        host_reading_process, monkeypatch):
    """Where the chunk's draw is captured, a registered generator that
    reads the host raises an error naming the process and the eager route
    (chunk_epochs=0), and the families' own draws pass the same check; an
    uncaptured draw of that generator trains (the per-epoch loop)."""
    monkeypatch.setattr(chunked, "sync_debug_mode", sync_mode_on_the_cpu)
    loader = DataLoader(0, NT, host_reading_process, 0.25, False, {},
                        device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match=(
            f"registered process '{HOST_READING}' reads the host.*"
            r"chunk_epochs=0 runs the per-epoch loop")):
        T._draw(loader, gen, True, "chunk_epochs=0 runs the per-epoch loop")
    assert T._draw(loader, gen, False, "")[0].shape[0] == NT
    # through the chunk's own draw, as its warm-up calls it
    trainer = port_trainer(NeuralJumpODE(1, H, 1, num_moments=2,
                                         device="cpu"))
    run = T._ChunkRun(trainer, loader, None, None, BS, True, False,
                      capture=False, defer=True, n_slots=5)
    run.epoch.capture = True
    with pytest.raises(RuntimeError, match=f"'{HOST_READING}'.*"
                                           "chunk_epochs=0"):
        run._data()
    for process in FAMILIES:
        for obs_only in (True, False):
            run = chunk_run(process, obs_only)
            run.epoch.capture = True
            run.streams.seed(0)
            assert torch.isfinite(run._data()[1]).all()
    hist = trainer.train(loader, n_epochs=2, batch_size=BS, chunk_epochs=0)
    assert len(hist["train_loss"]) == 2
