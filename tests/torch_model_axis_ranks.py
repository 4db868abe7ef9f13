"""Rank bodies of the model-axis CPU tests (tests/test_torch_model_axis.py).

``njode_tpu_torch.parallel.launch`` spawns each rank, which imports this
module by name; it imports the port and never JAX.  Each body runs several
cases in one world and returns plain tensors and numbers, every model state
in the one-process layout, for the test process to compare with the
single-process port and with the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil

import torch
import torch.distributed as dist

import torch_parallel_ranks as R
from njode_tpu_torch.models import NeuralJumpODE, nj_ode_loss_dense
from njode_tpu_torch.ops import fused_cell, fused_step
from njode_tpu_torch.parallel import (ModelShard, global_mesh, make_mesh,
                                     shard_params)
from njode_tpu_torch.parallel import collectives
from njode_tpu_torch.parallel.collectives import GatherBlocks, join
from njode_tpu_torch.utils import Trainer, make_adam

H16 = 16                  # the shared network of JAX's hidden-axis test


def shared16(state=None, **kw):
    model = NeuralJumpODE(1, H16, 1, num_moments=2, shared_network=True,
                          device="cpu", **kw)
    if state is not None:
        model.load_state_dict(state)
    return model


def full_grads(shard: ModelShard, model) -> dict:
    """Every parameter's gradient in the one-process layout, gathered over
    the model group (blocks and networks from their ranks)."""
    local = dict(model.named_parameters())
    own = {it.name: it for it in shard.items}
    parts = []
    for name in shard.names:
        it = own.get(name)
        piece, rows = None, None
        if it is not None and it.kind == "rows":
            piece, rows = it.tensor.grad, it.rows
        elif it is not None and (it.kind == "network" or shard.primary):
            piece = local[shard.local_name(name)].grad
        parts.append((shard.full_shapes[name], torch.float32, piece, rows))
    return dict(zip(shard.names, join(shard.mesh, parts, model.device)))


def loss_of(model, times, values):
    preds, before = model.apply(times, values)
    return nj_ode_loss_dense(values, preds, before,
                             moment_weights=(1.0, 10.0))


class SummingGather(GatherBlocks):
    """The trap: a gather whose backward sums the incoming gradient over the
    model group before it takes this rank's slice (a reduce-scatter)."""

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.mesh.model_group)
        return GatherBlocks.backward(ctx, grad)

    @staticmethod
    def forward(ctx, x, mesh, dim, lo, total):
        ctx.mesh = mesh
        return GatherBlocks.forward(ctx, x, mesh, dim, lo, total)


def forward_and_grads(model, shard, times, values) -> dict:
    """The gathered forward, the loss and every gradient (one-process
    layout) of one backward."""
    loss = loss_of(model, times, values)
    loss.backward()
    shard.after_backward()
    preds, before = model.apply(times, values)
    return {"preds": preds.detach(), "before": before.detach(),
            "loss": float(loss), "grads": full_grads(shard, model)}


def spy_kernels() -> dict:
    """Record the network count of every plain fused-step and fused-cell
    call (what a card would launch: the kernels' Kn and K_h)."""
    seen = {"step_fwd": [], "step_bwd": [], "cell": []}
    f_fwd = fused_step.fused_step_forward_reference
    f_bwd = fused_step.fused_step_backward_reference
    f_cell = fused_cell.fused_cell_reference

    def fwd(W, V, times, values, lo, *a, **k):
        seen["step_fwd"].append(lo.Kn)
        return f_fwd(W, V, times, values, lo, *a, **k)

    def bwd(W, V, times, values, gy, lo, *a, **k):
        seen["step_bwd"].append(lo.Kn)
        return f_bwd(W, V, times, values, gy, lo, *a, **k)

    def cell(inp, h, *a, **k):
        seen["cell"].append(h.shape[0])
        return f_cell(inp, h, *a, **k)
    fused_step.fused_step_forward_reference = fwd
    fused_step.fused_step_backward_reference = bwd
    fused_cell.fused_cell_reference = cell
    return seen


def train_state(tr, **kw) -> tuple:
    """Trainer.train on tests/torch_parallel_ranks.py's fixed data; the
    history, the one-process state and its optimizer state and the
    output."""
    hist, text = R.train_fixed(tr, **kw)
    sd, osd = tr.full_state()
    return hist, {k: v.detach().clone() for k, v in sd.items()}, osd, text


def two_rank_cases(state: dict, state16: dict, one_ckpt: str,
                   workdir: str, cfgs: dict, exp_state: dict,
                   data: tuple, ens_model_kw: dict,
                   ens_train_kw: dict) -> dict:
    """Every case of a 1 x 2 mesh (module docstring of the test)."""
    from njode_tpu_torch.utils import training as T
    from njode_tpu_torch.utils.ensemble import (shard_ensemble,
                                                train_ensemble_full)
    out = {}
    mesh = make_mesh(data=1, model=2, devices=["cpu", "cpu"])
    out["mesh"] = (mesh.shape, mesh.rank, mesh.data_rank, mesh.model_rank,
                   mesh.backend, mesh.data_group is None,
                   mesh.model_group is None)
    errors = {}
    for name, call in (
            ("too_few", lambda: make_mesh(data=2, model=2,
                                          devices=["cpu"] * 2)),
            ("world", lambda: make_mesh(data=2, model=2))):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["mesh_errors"] = errors
    out["default_data"] = make_mesh(model=2, devices=["cpu"] * 2).shape
    gm = global_mesh(model=2)
    out["global_mesh"] = (gm.shape, gm.model_rank, str(gm.device))
    # ---- shard_params on state dicts: what this rank keeps
    out["shard_moments"] = sorted(shard_params(mesh, dict(state),
                                               moment_axis=True))
    out["shard_hidden"] = {k: tuple(v.shape) for k, v in shard_params(
        mesh, dict(state16), hidden_axis=True).items()}
    times, values = (torch.as_tensor(a) for a in R.make_data(8, seed=2))

    # ---- "moments": the forward, the gradients, and the trap
    model = R.model_from(state)
    shard = shard_params(mesh, model, moment_axis=True)
    out["moments_local"] = (model.local_moments, model.k_hidden,
                            sorted(dict(model.named_parameters())))
    out["moments"] = forward_and_grads(model, shard, times, values)
    gathers = collectives.GATHERS
    with torch.no_grad():
        model.apply(times, values)
    out["gathers_a_forward"] = collectives.GATHERS - gathers
    GatherBlocks.apply = SummingGather.apply
    try:
        trap = R.model_from(state)
        out["trap"] = forward_and_grads(
            trap, ModelShard(mesh, trap, "moments"), times, values)
    finally:
        del GatherBlocks.apply          # Function's own, inherited again
    # ---- "hidden" on JAX's shared network of hidden 16
    model = shared16(state16)
    shard = shard_params(mesh, model, hidden_axis=True)
    out["hidden_kinds"] = {it.name: it.kind for it in shard.items}
    out["hidden"] = forward_and_grads(model, shard, times, values)

    # ---- 3 epochs under each mode against one process and JAX
    out["held"] = {}
    for mode in ("moments", "hidden"):
        for bs in (None, R.BS):
            tr = R.trainer_from(state, mesh, model_shard=mode)
            out[("train", mode, bs)] = train_state(tr, batch_size=bs) + (
                tr.grad_reductions,)
        out["held"][mode] = tr.shard.held_bytes(tr.optimizer)
    m16 = shared16(state16)
    tr = Trainer(m16, make_adam(m16.parameters(), R.LR, R.WD),
                 ignore_first_continuity=True, moment_weights=R.MW, seed=5,
                 mesh=mesh, model_shard="hidden")
    out[("train", "hidden16", R.BS)] = train_state(tr)

    # ---- dropout: a stream a network, the same under any placement
    for mode in ("moments", "hidden"):
        tr = R.trainer_from(state, mesh, model_kw=dict(dropout_rate=0.2),
                            model_shard=mode)
        out[("dropout_draws", mode)] = [torch.rand(8, generator=g)
                                        for g in tr._dropout_generator(0)]
        out[("dropout", mode)] = train_state(tr, n_epochs=1)

    # ---- the kernel routes' plain versions on each rank's slice
    seen = spy_kernels()
    for mode in ("step", True):
        for shard_mode in ("moments", "hidden"):
            for v in seen.values():
                v.clear()
            tr = R.trainer_from(state, mesh, model_kw=dict(use_pallas=mode),
                                model_shard=shard_mode)
            res = train_state(tr, n_epochs=2)
            out[("pallas", mode, shard_mode)] = res + (
                {k: list(v) for k, v in seen.items()},)

    # ---- checkpoints: to and from one process, resumes, DCP
    for mode in ("moments", "hidden"):
        path = f"{workdir}/from_one_{mode}/model.ckpt"
        if mesh.rank == 0:
            os.makedirs(os.path.dirname(path))
            shutil.copy(one_ckpt, path)
        dist.barrier()
        tr = R.trainer_from(None, mesh, model_shard=mode)
        out[("from_one", mode)] = train_state(tr, n_epochs=3, save_path=path)
        for backend in ("msgpack", "orbax"):
            path = f"{workdir}/{mode}_{backend}/model.ckpt"
            tr = R.trainer_from(state, mesh, checkpoint_backend=backend,
                                model_shard=mode)
            written = train_state(tr, n_epochs=2, save_path=path)
            tr = R.trainer_from(None, mesh, checkpoint_backend=backend,
                                model_shard=mode)
            out[("resume", mode, backend)] = (written,) + train_state(
                tr, n_epochs=3, save_path=path)

    # ---- run_experiment --model-parallel 2 on fixed data and weights
    (tt, tv), (vt, vv) = data
    loaders = T.create_data_loaders
    model_cls = T.NeuralJumpODE
    T.create_data_loaders = lambda **kw: (lambda: (tt, tv),
                                          lambda: (vt, vv))

    class FromInit(NeuralJumpODE):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.load_state_dict(exp_state)
    T.NeuralJumpODE = FromInit
    try:
        for name, cfg in cfgs.items():
            with contextlib.redirect_stdout(io.StringIO()) as text:
                res = T.run_experiment(cfg, workdir)
            out[("experiment", name)] = (res, text.getvalue())
    finally:
        T.create_data_loaders, T.NeuralJumpODE = loaders, model_cls

    # ---- ensembles: the seed axis on the model axis
    stack = {"w": torch.arange(12.).reshape(4, 3)}
    out["shard_ensemble"] = (shard_ensemble(mesh, stack)["w"],
                             shard_ensemble(mesh, list(range(4))),
                             shard_ensemble(mesh, stack, axis="data")["w"])
    out["ensemble"] = train_ensemble_full(
        NeuralJumpODE(device="cpu", **ens_model_kw), "black_scholes",
        n_seeds=2, mesh=mesh, **ens_train_kw)
    return out


def four_rank_cases(state: dict, state16: dict) -> dict:
    """A 2 x 2 mesh under "moments" and a 1 x 4 mesh under "hidden"."""
    out = {}
    mesh = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    out["mesh"] = (mesh.rank, mesh.data_rank, mesh.model_rank)
    for bs in (None, R.BS):
        gathers = collectives.GATHERS
        tr = R.trainer_from(state, mesh, model_shard="moments")
        out[("moments", bs)] = train_state(tr, batch_size=bs) + (
            tr.grad_reductions,)
        out[("gathers", bs)] = collectives.GATHERS - gathers
    mesh4 = make_mesh(data=1, model=4, devices=["cpu"] * 4)
    times, values = (torch.as_tensor(a) for a in R.make_data(8, seed=2))
    model = shared16(state16)
    shard = shard_params(mesh4, model, hidden_axis=True)
    out["hidden_kinds"] = {it.name: it.kind for it in shard.items}
    out["hidden"] = forward_and_grads(model, shard, times, values)
    m16 = shared16(state16)
    tr = Trainer(m16, make_adam(m16.parameters(), R.LR, R.WD),
                 ignore_first_continuity=True, moment_weights=R.MW, seed=5,
                 mesh=mesh4, model_shard="hidden")
    out["hidden_train"] = train_state(tr)
    return out
