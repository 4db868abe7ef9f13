"""Rank bodies of the data-parallel CPU tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py).

``njode_tpu_torch.parallel.launch`` spawns each rank, which imports this
module by name; it imports the port and never JAX, so a rank starts fast
and the port's no-JAX rule holds in it.  Each body runs several cases in
one world and returns plain tensors and numbers for the test process to
compare with the single-process port and with the JAX package.
"""

from __future__ import annotations

import io
import contextlib

import numpy as np
import torch

from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.parallel import make_mesh
from njode_tpu_torch.utils import Trainer, make_adam

H, N, NT, BS = 12, 5, 40, 16
LR, WD = 1e-3, 5e-4
MW = [1.0, 10.0]
POP_LRS = [1e-2, 3e-3, 1e-3, 3e-4]


def make_data(n=NT, seed=0, n_slots=N):
    """Fixed (times, values) from numpy: sorted grid indices, lognormal
    values (tests/test_torch_training.py's ``make_data``)."""
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 100), n_slots - 1, replace=False)])
        for _ in range(n)]), axis=1)
    times = (idx * 0.01).astype(np.float32)
    values = np.exp(rng.normal(size=(n, n_slots, 1)) * 0.3).astype(np.float32)
    return times, values


def model_from(state, **kw):
    model = NeuralJumpODE(1, H, 1, num_moments=2, device="cpu", **kw)
    if state is not None:
        model.load_state_dict(state)
    return model


def trainer_from(state, mesh=None, seed=5, model_kw=None, **kw):
    model = model_from(state, **(model_kw or {}))
    return Trainer(model, make_adam(model.parameters(), LR, WD),
                   ignore_first_continuity=True, moment_weights=MW,
                   seed=seed, mesh=mesh, **kw)


def train_fixed(trainer, n_epochs=3, batch_size=BS, n=NT, save_path=None,
                data_seed=0):
    """Trainer.train on fixed data, shuffle off, validation on 12."""
    times, values = make_data(n, seed=data_seed)
    vt, vv = make_data(12, seed=1)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        hist = trainer.train(lambda: (times, values), lambda: (vt, vv),
                             n_epochs=n_epochs, batch_size=batch_size,
                             shuffle=False, print_every=1,
                             save_path=save_path)
    return hist, out.getvalue()


def state_of(trainer) -> dict:
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


def parallel_cases(state: dict, workdir: str) -> dict:
    """The Trainer and mesh cases, on one rank of a 2-rank CPU world."""
    out = {}
    # ---- the mesh: shapes and errors
    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    out["mesh"] = (mesh.shape, (mesh.rank, mesh.data_rank), mesh.backend,
                   str(mesh.device))
    errors = {}
    for name, call in (
            ("too_few", lambda: make_mesh(data=4, devices=["cpu"] * 2)),
            ("model_axis", lambda: make_mesh(data=1, model=2,
                                             devices=["cpu", "cpu"])),
            ("world", lambda: make_mesh(data=1, devices=["cpu"]))):
        try:
            call()
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    out["mesh_errors"] = errors
    # ---- 3 epochs of the full batch (JAX's test_dp_matches_single_device)
    tr = trainer_from(state, mesh)
    hist, _ = train_fixed(tr, batch_size=None)
    out["full"] = (hist, state_of(tr), tr.grad_reductions)
    # ---- minibatches of 16 over 40 rows: the last holds 8 valid rows,
    # all on rank 0 (a mean of the shards' means would double them)
    tr = trainer_from(state, mesh)
    hist, text = train_fixed(tr)
    out["ragged"] = (hist, state_of(tr), tr.grad_reductions, text)
    # ---- a minibatch of 15 rows: the data axis does not divide it, so
    # every rank holds it whole and nothing is reduced
    tr = trainer_from(state, mesh)
    hist, _ = train_fixed(tr, batch_size=15)
    out["uneven"] = (hist, state_of(tr), tr.grad_reductions)
    # ---- dropout: a stream per (seed, epoch, rank) where the rows split
    tr = trainer_from(state, mesh, model_kw=dict(dropout_rate=0.2))
    out["dropout_draws"] = {
        name: torch.stack([torch.rand(8, generator=g)
                           for g in tr._dropout_generator(0, sharded)])
        for name, sharded in (("sharded", True), ("whole", False))}
    hist, _ = train_fixed(tr, n_epochs=1)
    out["dropout"] = (hist, state_of(tr))
    # ---- the fused step's and the forced kernels' plain versions
    for mode in ("step", True):
        tr = trainer_from(state, mesh, model_kw=dict(use_pallas=mode))
        hist, text = train_fixed(tr, n_epochs=2)
        out[f"pallas_{mode}"] = (hist, state_of(tr), text)
    # ---- resume with both backends: 2 epochs, then 1 more
    for backend in ("msgpack", "orbax"):
        path = f"{workdir}/{backend}/model.ckpt"
        tr = trainer_from(state, mesh, checkpoint_backend=backend)
        train_fixed(tr, n_epochs=2, save_path=path)
        tr = trainer_from(None, mesh, seed=5, checkpoint_backend=backend)
        hist, text = train_fixed(tr, n_epochs=3, save_path=path)
        out[f"resume_{backend}"] = (hist, state_of(tr), text)
    return out


def distributed_cases(ens_model_kw: dict, ens_train_kw: dict, cfg: dict,
                      state: dict, data: tuple, save_dir: str,
                      ens_cfg: dict) -> dict:
    """On one rank of a 2-rank CPU world: train_ensemble_full over the
    mesh with K=4 (two members a rank) and K=3 (every rank trains all
    three) and a population of POP_LRS; run_experiment of ``ens_cfg`` (an
    ensemble with the "orbax" checkpoints) for 2 epochs, then resumed to
    its own; run_experiment(data_parallel=2) inside the group, on fixed
    data and initial weights; initialize_distributed inside the group."""
    from njode_tpu_torch.parallel import initialize_distributed
    from njode_tpu_torch.utils import training as T
    from njode_tpu_torch.utils.ensemble import (train_ensemble_full,
                                                train_population)
    # JAX's ensemble mesh: the members over the model axis
    mesh = make_mesh(data=1, model=2, devices=["cpu", "cpu"])
    out = {"rank": initialize_distributed()}
    for k in (4, 3):
        model = NeuralJumpODE(device="cpu", **ens_model_kw)
        out[k] = train_ensemble_full(model, "black_scholes", n_seeds=k,
                                     mesh=mesh, **ens_train_kw)
    out["population"] = train_population(
        NeuralJumpODE(device="cpu", **ens_model_kw), "black_scholes",
        POP_LRS, mesh=mesh, **{k: v for k, v in ens_train_kw.items()
                               if k != "optimizer"})
    with contextlib.redirect_stdout(io.StringIO()) as text:
        T.run_experiment(dict(ens_cfg, n_epochs=2), save_dir)
        out["ensemble_experiment"] = T.run_experiment(ens_cfg, save_dir)
    out["ensemble_text"] = text.getvalue()
    (tt, tv), (vt, vv) = data
    T.create_data_loaders = lambda **kw: (lambda: (tt, tv),
                                          lambda: (vt, vv))

    class FromInit(NeuralJumpODE):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.load_state_dict(state)
    T.NeuralJumpODE = FromInit
    with contextlib.redirect_stdout(io.StringIO()) as text:
        out["experiment"] = T.run_experiment(cfg, save_dir)
    out["experiment_text"] = text.getvalue()
    return out


def fails_on_rank_one() -> int:
    """Rank 1 raises while rank 0 waits at a barrier."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank one fails here")
    dist.barrier()
    return 0


def never_returns() -> None:
    import time
    time.sleep(3600)


def sleeps(seconds: float) -> float:
    import time
    time.sleep(seconds)
    return seconds
