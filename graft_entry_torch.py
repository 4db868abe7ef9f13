"""Entry points of the PyTorch port: the flagship forward and the multi-chip
dry run over ``torch.distributed`` ranks (the JAX package's
``__graft_entry__.py``, which stays as it is).

    python graft_entry_torch.py [N]

runs ``dryrun_multichip(N)`` (default 4): one rank a card where there are N
cards (NCCL); where there are fewer, the ranks take the cards in turn over
gloo; with no card, N gloo ranks on the CPU.  Each pass prints "... OK".
"""

from __future__ import annotations

import contextlib
import io
import math
import sys
import tempfile
from typing import Optional, Sequence

import torch

def _flagship(device) -> "NeuralJumpODE":
    """The default Black-Scholes recipe's model (hidden 32, two separate
    networks, relu), weights from seed 0."""
    from njode_tpu_torch import NeuralJumpODE
    return NeuralJumpODE(input_dim=1, hidden_dim=32, output_dim=1,
                         num_moments=2, n_hidden_layers=1, activation="relu",
                         shared_network=False, variance_method="direct",
                         t_max=1.0, device=device,
                         generator=torch.Generator().manual_seed(0))


def _bs_batch(n: int, device, seed: int = 1, **kw):
    from njode_tpu_torch.simulation import simulate_batch
    gen = torch.Generator(device=device).manual_seed(seed)
    return simulate_batch(n, "black_scholes", kw.pop("obs_fraction", 0.1),
                          generator=gen, device=device,
                          **{"mu": 0.1, "sigma": 0.5, "T": 1.0,
                             "n_steps": 100, "x0": 1.0, **kw})


def entry(device=None):
    """Returns (fn, example_args): the flagship model's forward
    (``apply``) and a batch of 32 Black-Scholes paths, on the card unless
    ``device`` says otherwise."""
    from njode_tpu_torch.models.jump_ode import resolve_device
    dev = resolve_device(device)
    model = _flagship(dev)
    batch = _bs_batch(32, dev)

    def fn(times, values, mask):
        return model.apply(times, values, mask)
    return fn, (batch.times, batch.values, batch.mask)


def _step(trainer, batch) -> float:
    """One Adam step of ``trainer`` on ``batch``: the loss summed over the
    data axis (each rank's share of the global mean)."""
    loss = trainer._step(batch.times, batch.values, batch.mask, None, None)
    if trainer._rows(batch.times.shape[0]) is not None:
        loss = trainer._sum_over_ranks(loss)
    return float(loss)


def _dryrun_rank(n: int, devices: list, workdir: str) -> list[str]:
    """The passes on one rank (``workdir``: a directory every rank sees,
    for the checkpoint); returns the lines rank 0 prints."""
    from njode_tpu_torch import NeuralJumpODE
    from njode_tpu_torch.parallel import make_mesh
    from njode_tpu_torch.utils import Trainer, make_adam
    from njode_tpu_torch.utils.ensemble import (train_ensemble,
                                                train_population)
    from njode_tpu_torch.utils.training import create_data_loaders

    lines = []
    n_model = 2 if (n % 2 == 0 and n >= 4) else 1
    n_data = n // n_model
    mesh = make_mesh(data=n_data, model=n_model, devices=devices)
    dev = mesh.device
    lines.append(f"mesh: data={n_data} model={n_model} ({n} ranks, "
                 f"backend={mesh.backend}, devices={devices})")

    def finite(x, what):
        if not math.isfinite(x):
            raise AssertionError(f"non-finite {what}: {x}")
        return x

    def trainer(model, **kw):
        return Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                       ignore_first_continuity=True,
                       moment_weights=[1.0, 10.0], mesh=mesh, **kw)

    # ---- pass 1: the production step (reference run_black_scholes.sh's
    # flags: hidden 50, a shared network, dt_ode_step 0.01: the substep
    # loop) over the data axis, the model replicated on the model axis
    def production():
        return NeuralJumpODE(input_dim=1, hidden_dim=50, output_dim=1,
                             num_moments=2, shared_network=True,
                             dt_ode_step=0.01, t_max=1.0, device=dev,
                             generator=torch.Generator().manual_seed(0))
    batch = _bs_batch(4 * n_data, dev)
    loss = finite(_step(trainer(production()), batch), "loss")
    lines.append(f"dryrun_multichip({n}): production DP step OK, "
                 f"loss={loss:.6f}")

    # ---- pass 1b: EP, the moment networks over the model axis
    if n_model > 1:
        ep = NeuralJumpODE(input_dim=1, hidden_dim=32, output_dim=1,
                           num_moments=2, shared_network=False, t_max=1.0,
                           device=dev,
                           generator=torch.Generator().manual_seed(3))
        loss = finite(_step(trainer(ep, model_shard="moments"), batch),
                      "EP loss")
        lines.append(f"dryrun_multichip({n}): EP pass OK, loss={loss:.6f}")

    # ---- pass 2: TP, the hidden axis over the model axis
    if n_model > 1:
        tp = NeuralJumpODE(input_dim=1, hidden_dim=16 * n_model,
                           output_dim=1, num_moments=2, shared_network=True,
                           t_max=1.0, device=dev,
                           generator=torch.Generator().manual_seed(2))
        loss = finite(_step(trainer(tp, model_shard="hidden"), batch),
                      "TP loss")
        lines.append(f"dryrun_multichip({n}): TP pass OK, loss={loss:.6f}")

    # ---- passes 3 and 4: the Trainer on the mesh, then a checkpoint
    # resume (preemption under the mesh)
    data = {"process_type": "black_scholes", "n_train": 4 * n_data,
            "n_val": 2 * n_data, "obs_fraction": 0.1, "T": 1.0,
            "n_steps": 100, "mu": 0.1, "sigma": 0.5, "x0": 1.0}
    train_fn, val_fn = create_data_loaders(cache_data=False, device=dev,
                                           **data)
    config = {"data": data}
    ckpt = f"{workdir}/model.ckpt"
    with contextlib.redirect_stdout(io.StringIO()):
        hist = trainer(production()).train(
            train_fn, val_fn, n_epochs=2, print_every=2, save_path=ckpt,
            config=config)
    for x in hist["train_loss"]:
        finite(x, "trainer loss")
    lines.append(f"dryrun_multichip({n}): trainer OK, losses="
                 f"{[round(x, 4) for x in hist['train_loss']]}")
    with contextlib.redirect_stdout(io.StringIO()):
        hist2 = trainer(production()).train(
            train_fn, val_fn, n_epochs=4, print_every=2, save_path=ckpt,
            config=config, resume_from_checkpoint=True)
    if (len(hist2["train_loss"]) != 4
            or hist2["train_loss"][:2] != hist["train_loss"][:2]):
        raise AssertionError(f"resume: {hist2['train_loss']} after "
                             f"{hist['train_loss']}")
    lines.append(f"dryrun_multichip({n}): checkpoint resume OK, losses="
                 f"{[round(x, 4) for x in hist2['train_loss']]}")

    # ---- pass 5: a seed ensemble, the seed axis over the model axis, on
    # exact observation-time data (obs_only)
    ens_model = NeuralJumpODE(input_dim=1, hidden_dim=16, output_dim=1,
                              num_moments=2, t_max=1.0, device=dev)
    K = max(2, n_model)
    kw = dict(n_epochs=2, n_trajectories=4 * n_data, batch_size=None,
              obs_fraction=0.2, mesh=mesh, obs_only=True, T=1.0, n_steps=20,
              mu=0.1, sigma=0.5, x0=1.0)
    _, ens_losses = train_ensemble(ens_model, "black_scholes", n_seeds=K,
                                   **kw)
    if tuple(ens_losses.shape) != (2, K) or not bool(
            torch.isfinite(ens_losses).all()):
        raise AssertionError(f"ensemble losses {ens_losses}")
    lines.append(f"dryrun_multichip({n}): sharded ensemble + obs_only OK, "
                 f"final losses={[round(float(x), 4) for x in ens_losses[-1]]}")

    # ---- pass 6: a learning-rate population, each member's optimizer
    # with its member over the model axis
    pop_lrs = [10.0 ** -(2 + i % 3) for i in range(K)]
    _, _, pop_hist = train_population(ens_model, "black_scholes", pop_lrs,
                                      **kw)
    pop = pop_hist["train"]
    if tuple(pop.shape) != (2, K) or not bool(torch.isfinite(pop).all()):
        raise AssertionError(f"population losses {pop}")
    lines.append(f"dryrun_multichip({n}): sharded lr-population OK, "
                 f"lrs={pop_lrs}, final losses="
                 f"{[round(float(x), 4) for x in pop[-1]]}")
    return lines


def default_devices(n: int) -> list[str]:
    """The dry run's devices for ``n`` ranks: rank r on card r % cards, the
    CPU only where there is no card."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ([f"cuda:{r % cards}" for r in range(n)] if cards
            else ["cpu"] * n)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence[str]] = None) -> None:
    """The JAX package's six passes over ``n_devices`` torch ranks on a
    (data, model) mesh (a model axis of 2 where n is even and >= 4): the
    production step over the data axis, EP ("moments"), TP ("hidden"), the
    Trainer, a checkpoint resume, and a sharded ensemble and population.
    ``devices``: one per rank; by default rank r on card r % cards (NCCL
    where every rank has a card of its own, else gloo), and the CPU only
    where there is no card (``["cpu"] * n_devices`` asks for it).  Prints
    rank 0's lines, the mesh's devices first, each pass "... OK"; a failed
    pass raises."""
    from njode_tpu_torch.parallel import launch
    devices = (default_devices(n_devices) if devices is None
               else list(devices))
    with tempfile.TemporaryDirectory() as workdir:
        lines = launch(_dryrun_rank, n_devices,
                       args=(n_devices, devices, workdir),
                       devices=devices)[0]
    for line in lines:
        print(line, flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
