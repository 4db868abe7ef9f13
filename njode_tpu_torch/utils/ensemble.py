"""Multi-seed ensembles and hyperparameter populations (port of
``njode_tpu.utils.ensemble``).

K members train with the same recipe and differ in their seeds (an
ensemble) or in their optimizer's hyperparameters (a population).  Each
member is a copy of the model with its own ``torch.optim.Adam`` and its own
:class:`~njode_tpu_torch.utils.Trainer`, whose ``_epoch_update`` is the
single model's epoch.  Kernels are the single model's too: under
``use_pallas=True`` every member trains through the gap loop's training
pair, under ``"step"`` through the fused step.

* **One program an epoch.** The JAX package runs a chunk's epochs of all K
  members as one vmapped ``lax.scan`` (``run_chunk``,
  ``njode_tpu/utils/ensemble.py:226-278``).  The port's counterpart is one
  :class:`~.chunked.EpochProgram` an epoch over all K members
  (:class:`_EnsembleRun`): each data seed's batch, each member's epoch,
  validation and relative loss into (K,) rows on the device, read once a
  chunk.  On one card without a mesh it is captured as a CUDA graph after
  one eager epoch and replayed; a mesh, ``debug_checks`` and the CPU run
  it eagerly.  ``chunked=False`` runs the member loop it replaces (members
  in turn, each row read every epoch), bit for bit the same.

* **Member streams.** Member s draws every random number from generators
  seeded by (seed or data_seed, s, stream, epoch) alone
  (:func:`_member_seeds` on top of ``stream_seed``): its init, its
  training, validation and relative-loss data, its shuffle and its
  dropout.  So member s is the same in an ensemble of any size.
  ``share_data=True`` gives every member the data streams of ``data_seed``
  itself; inits, shuffles and dropout stay the member's own.
* **The stack.** :func:`init_ensemble` returns a dict from the model's
  ``state_dict`` keys to ``(K, ...)`` tensors, the port's counterpart of
  the JAX pytree's leading ``(K,)`` axis.  Each member's init is drawn on
  the CPU, so a stack is the same on the card and on the CPU.
* **Optimizer state.** A list of K ``torch.optim.Adam`` state dicts.
* ``ensemble_predict`` + ``ensemble_mean_std``: epistemic (seed) bands
  around the conditional-moment predictions.

* **Over ranks.** With a ``mesh``
  (:func:`njode_tpu_torch.parallel.make_mesh`; ``run_experiment`` builds
  JAX's ``make_mesh(data=1, model=n_dev)``), the rank at model coordinate
  r trains its K/M members (:func:`shard_ensemble`: a contiguous block of
  the seed axis on the model axis, as the JAX package places it), each
  with the streams of its global index, so a member is the same whichever
  rank trains it.  At every checkpoint and at the end the model group's
  ranks join their members' states and loss rows (one object broadcast a
  rank), so every rank returns the whole ensemble.  A K the model axis
  does not divide is trained whole on every rank.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..models import NeuralJumpODE
from ..models.jump_ode import DeferredGuards
from .training import (STREAM_MEMBER, STREAM_TRAIN, STREAM_VAL, DataLoader,
                       Trainer, _draw, _Streams, as_dense,
                       load_optimizer_state, make_adam, stream_seed)

# the optimizer's hyperparameter names (the JAX package's) -> Adam's keys
_HPARAM_KEYS = {"learning_rate": "lr", "weight_decay": "weight_decay"}


def _member_seeds(base: int, n_seeds: int,
                  share_data: bool = False) -> list[int]:
    """Member s's seed depends only on (base, s), never on n_seeds;
    ``share_data=True`` gives every member ``base`` itself.  The one
    derivation for training, validation and relative-loss data, and (never
    shared) for inits, shuffles and dropout."""
    if share_data:
        return [int(base)] * n_seeds
    return [stream_seed(base, STREAM_MEMBER, s) for s in range(n_seeds)]


def _init_state(model: NeuralJumpODE,
                generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The state dict ``NeuralJumpODE(generator=generator)`` of the model's
    architecture would have: each Linear's weight, then its bias, drawn
    from U(-1/sqrt(fan_in), 1/sqrt(fan_in)) on the CPU in construction
    order (``models/mlp.py``), then cast and moved to the model's."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            for pname in ("weight", "bias"):
                p = getattr(mod, pname)
                t = torch.empty(p.shape, dtype=torch.float32)
                nn.init.uniform_(t, -bound, bound, generator=generator)
                out[f"{name}.{pname}"] = t.to(dtype=p.dtype, device=p.device)
    if out.keys() != model.state_dict().keys():
        raise ValueError("the model holds state other than its Linear "
                         "layers' weights and biases")
    return out


def stack_states(states: list[dict]) -> dict[str, torch.Tensor]:
    """K state dicts -> one stack: every tensor gains a leading (K,) axis."""
    return {k: torch.stack([s[k].detach() for s in states])
            for k in states[0]}


def member_state(params_stack: dict, s: int) -> dict[str, torch.Tensor]:
    """Member s's state dict out of a stack."""
    return {k: v[s] for k, v in params_stack.items()}


def n_members(params_stack: dict) -> int:
    return int(next(iter(params_stack.values())).shape[0])


def init_ensemble(model: NeuralJumpODE, n_seeds: int, seed: int = 0):
    """The stack of K independently initialised members: member s as
    ``NeuralJumpODE`` inits from a CPU generator seeded with member s's
    seed."""
    return stack_states([
        _init_state(model, torch.Generator().manual_seed(ms))
        for ms in _member_seeds(seed, n_seeds)])


class PopulationAdam:
    """An optimizer factory whose hyperparameters each member may set for
    itself: called on a member's parameters it returns ``make_adam`` at
    the defaults in ``hyperparams``, and ``member_hparams`` of
    :func:`train_ensemble_full` then sets each member's param group."""

    def __init__(self, learning_rate: float, weight_decay: float):
        self.hyperparams = {"learning_rate": float(learning_rate),
                            "weight_decay": float(weight_decay)}

    def __call__(self, params) -> torch.optim.Adam:
        return make_adam(params, self.hyperparams["learning_rate"],
                         self.hyperparams["weight_decay"])


def population_adam(learning_rate: float = 1e-3,
                    weight_decay: float = 0.0) -> PopulationAdam:
    """``make_adam`` with per-member learning rate and weight decay (the
    JAX package's ``optax.inject_hyperparams`` chain,
    ``njode_tpu/utils/ensemble.py:281-295``); with equal values a member's
    update is ``make_adam``'s."""
    return PopulationAdam(learning_rate, weight_decay)


def _member_hparams(optimizer, member_hparams: dict, n_seeds: int) -> dict:
    """Check ``member_hparams`` as the JAX package does
    (``njode_tpu/utils/ensemble.py:168-185``) and return them as (K,)
    float64 arrays."""
    hp = getattr(optimizer, "hyperparams", None)
    if hp is None:
        raise ValueError(
            "member_hparams requires an optimizer that carries its "
            "hyperparameters per member (the counterpart of "
            "optax.inject_hyperparams) — use population_adam()")
    upd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                         np.float64)
           for k, v in member_hparams.items()}
    unknown = sorted(set(upd) - set(hp))
    if unknown:
        raise ValueError(f"member_hparams keys {unknown} not in the "
                         f"optimizer's hyperparams {sorted(hp)}")
    bad = {k: v.shape for k, v in upd.items() if v.shape != (n_seeds,)}
    if bad:
        raise ValueError(f"member_hparams must be (n_seeds,) = "
                         f"({n_seeds},) arrays; got {bad}")
    return upd


def _seed_block(mesh, k: int, axis: str = "model") -> Optional[slice]:
    """This rank's contiguous block of K members on ``axis`` of ``mesh``,
    or None where the axis holds one rank or does not divide K > 1."""
    n = mesh.shape[axis] if mesh is not None else 1
    if n <= 1 or k <= 1 or k % n:
        return None
    per = k // n
    r = mesh.axis_rank(axis)
    return slice(r * per, (r + 1) * per)


def shard_ensemble(mesh, tree, axis: str = "model"):
    """This rank's members of ``tree``: a stack (a dict of ``(K, ...)``
    tensors) or a list of K per-member items, cut to the rank's contiguous
    block of the seed axis on the mesh's ``axis`` (JAX's default, the model
    axis).  A K the axis does not divide stays whole
    (``njode_tpu/utils/ensemble.py:71-88`` replicates it).  Members are
    independent: nothing crosses the seed axis while they train."""
    k = n_members(tree) if isinstance(tree, dict) else len(tree)
    sl = _seed_block(mesh, k, axis)
    if sl is None:
        return tree
    if isinstance(tree, dict):
        return {name: v[sl] for name, v in tree.items()}
    return tree[sl]


def _cpu(obj):
    """``obj`` with every tensor moved to the CPU (dicts and lists
    followed)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _join_members(mesh, items: list, n_seeds: int) -> list:
    """Every model rank's per-member ``items`` (its block of the seed
    axis), in member order, on every rank of its model group: each rank
    broadcasts its block as one object.  Tensors travel through the CPU."""
    import torch.distributed as dist
    per = n_seeds // mesh.n_model
    out = []
    for r in range(mesh.n_model):
        buf = [_cpu(items) if r == mesh.model_rank else None]
        dist.broadcast_object_list(buf, src=mesh.data_rank * mesh.n_model + r,
                                   group=mesh.model_group)
        if len(buf[0]) != per:
            raise RuntimeError(f"rank {r} holds {len(buf[0])} members, "
                               f"{per} expected")
        out += buf[0]
    return out


def _members(model: NeuralJumpODE, params_stack: dict, opt_states,
             optimizer: Callable, hparams: Optional[dict], seeds: list[int],
             trainer_kw: dict) -> list[Trainer]:
    """A Trainer for each member: a copy of ``model`` holding the member's
    weights, a fresh optimizer (or the member's resumed state) with the
    member's hyperparameters, and the member's seed."""
    out = []
    for s, ms in enumerate(seeds):
        m = copy.deepcopy(model)
        m.load_state_dict(member_state(params_stack, s))
        opt = optimizer(m.parameters())
        if opt_states is not None:
            # a resumed step count goes where the optimizer steps it (on
            # the card for a capturable Adam)
            load_optimizer_state(opt, opt_states[s])
        for name, vals in (hparams or {}).items():
            for group in opt.param_groups:
                group[_HPARAM_KEYS[name]] = float(vals[s])
        out.append(Trainer(m, opt, seed=ms, **trainer_kw))
    return out


def _member_data(loaders: dict, seeds: list[int], epoch: int) -> list:
    """Each member's (times, values, mask) of an epoch; members that share a
    data seed share one batch."""
    batches = {}
    for ds in seeds:
        if ds not in batches:
            ld = loaders[ds]
            batches[ds] = as_dense(ld(epoch), ld.device)[:3]
    return [batches[ds] for ds in seeds]


class _EnsembleRun:
    """The epoch of all K members (this rank's, under a mesh) as one
    :class:`~.chunked.EpochProgram`, the port's ``run_chunk``: each data
    seed's batch from its loader's generator (members sharing a seed share
    the batch), each member's ``Trainer._epoch_update`` with its own
    shuffle and dropout streams (``_Streams``, reseeded before every
    epoch), then each member's validation and relative loss, into (K,)
    rows on the device.  ``capture``: a CUDA graph after one eager epoch
    (a program no later epoch calls is not captured).  ``defer``: the
    models' host-reading guards note on the device and raise after the
    chunk.  ``check_syncs`` (a check): every epoch of a chunk under
    ``set_sync_debug_mode("error")``."""

    check_syncs = False

    def __init__(self, members: list, loaders: dict, data_seeds: list,
                 val_data, rel_eval, idx: list, batch_size, shuffle: bool,
                 capture: bool, defer: bool, n_epochs: int):
        from .chunked import EpochProgram
        self.members, self.loaders = members, loaders
        self.data_seeds, self.val_data = data_seeds, val_data
        self.batch_size, self.shuffle = batch_size, shuffle
        self.n_epochs = n_epochs
        self.device = members[0].device
        self.guards = DeferredGuards() if defer else None
        self.streams, self.draws = [], {}
        for tr, ds in zip(members, data_seeds):
            st = _Streams(tr, loaders[ds], batch_size, shuffle, False,
                          draws=ds not in self.draws)
            self.draws.setdefault(ds, st)
            self.streams.append(st)
        self.rel = None
        if rel_eval is not None:
            self.rel = {k: rel_eval[k][idx] for k in ("times", "values",
                                                      "mask")}
            self.l_true = rel_eval["l_true"][idx].to(self.device).double()
        self.keys = (["train"] + (["val"] if val_data is not None else [])
                     + (["rel"] if rel_eval is not None else []))
        self.program = EpochProgram(
            self._body, capture,
            [g for st in self.streams for g in st.generators()],
            f"ensemble epoch of {len(members)} members", self.device)

    def release(self) -> None:
        self.program.release()

    def chunk(self, epoch: int, L: int) -> list:
        """Epochs epoch..epoch+L-1: a row a epoch, {key: K floats}, read
        in one transfer at the chunk's end; then the guards' check and
        each member's inference weights dropped (replays move the weights
        without bumping their versions)."""
        from .chunked import sync_debug_mode
        buf = torch.full((len(self.keys), L, len(self.members)), math.nan,
                         dtype=torch.float64, device=self.device)
        checked = self.check_syncs and self.device.type == "cuda"
        with sync_debug_mode("error") if checked else contextlib.nullcontext():
            for i in range(L):
                e = epoch + i
                for st in self.streams:
                    st.seed(e)
                out = self.program(again=e + 1 < self.n_epochs)
                for j, row in enumerate(out):
                    buf[j, i].copy_(row)
        host = buf.tolist()
        if self.guards is not None:
            self.guards.check()
        for tr in self.members:
            tr.model._drop_gap_cache()
        return [{k: host[j][i] for j, k in enumerate(self.keys)}
                for i in range(L)]

    def _body(self) -> tuple:
        with contextlib.ExitStack() as stack:
            if self.guards is not None:
                for tr in self.members:
                    stack.enter_context(tr.model.deferred_guards(self.guards))
            batches = {ds: _draw(self.loaders[ds], st.data,
                                 self.program.capture,
                                 "chunked=False runs the member loop")
                       for ds, st in self.draws.items()}
            out = [torch.stack([
                tr._epoch_update(*batches[ds], 0, self.batch_size,
                                 self.shuffle, st)
                for tr, ds, st in zip(self.members, self.data_seeds,
                                      self.streams)])]
            if self.val_data is not None:
                out.append(self._eval([
                    (tr, lambda t, v, m, tm, tr=tr: tr._loss(
                        t, v, m, traj_mask=tm), batch)
                    for tr, batch in zip(self.members, self.val_data)]))
            if self.rel is not None:
                lm = self._eval([
                    (tr, lambda t, v, m, tm, tr=tr: tr._loss_no_first(
                        t, v, m), tuple(self.rel[k][s] for k in (
                            "times", "values", "mask")))
                    for s, tr in enumerate(self.members)])
                # in float64, as the member loop's host arithmetic
                out.append((lm.double() - self.l_true)
                           / torch.clamp_min(self.l_true, 1e-8))
            return tuple(out)

    @staticmethod
    def _eval(cases: list) -> torch.Tensor:
        """(K,) evaluation losses, each member's inference weights cut
        afresh in the program."""
        losses = []
        for tr, loss_fn, batch in cases:
            tr.model._drop_gap_cache()
            with torch.no_grad():
                losses.append(tr._eval_loss(loss_fn, *batch))
        return torch.stack(losses)


def _ensemble_decline(members: list, loaders: dict, data_seeds: list,
                      mesh) -> Optional[str]:
    """None where the ensemble's epoch program is captured on the card,
    else why it runs eagerly: a mesh (each rank's members, their states
    joined over the process group), or a member's own reason
    (``Trainer._graph_decline``: ``debug_checks``, an optimizer that is not
    capturable, a loader elsewhere)."""
    if mesh is not None:
        return ("a mesh: each rank trains its members and joins them over "
                "the process group")
    for tr, ds in zip(members, data_seeds):
        reason = tr._graph_decline(False, loaders[ds])
        if reason is not None:
            return reason
    return None


def train_ensemble_full(model: NeuralJumpODE, process_type: str, n_seeds: int,
                        n_epochs: int, n_trajectories: int = 1000,
                        batch_size: Optional[int] = 128,
                        obs_fraction: float = 0.1,
                        optimizer: Optional[Callable] = None,
                        seed: int = 0, data_seed: int = 0,
                        shuffle: bool = True, share_data: bool = False,
                        mesh=None, obs_only: bool = False,
                        ignore_first_continuity: bool = True,
                        moment_weights=None, variance_method: str = "direct",
                        extended_moments: bool = False,
                        n_val: int = 0, rel_eval: Optional[dict] = None,
                        start_epoch: int = 0, initial_state=None,
                        chunk_len: Optional[int] = None, on_chunk=None,
                        member_hparams: Optional[dict] = None,
                        chunked: bool = True, verbose: bool = False,
                        **process_kwargs):
    """Train K members, recording their validation and relative losses,
    with chunked checkpoints and an exact resume (JAX semantics,
    ``njode_tpu/utils/ensemble.py:90-278``).

    * ``optimizer``: a callable from a member's parameters to its
      optimizer; default ``make_adam(params, 1e-3, 5e-4)``.
    * ``n_val > 0``: a fixed validation batch a member (its STREAM_VAL
      stream at epoch 0, so never a training epoch's data), its loss
      recorded every epoch (``Trainer.validate``).
    * ``rel_eval``: ``times/values/mask`` (K, n_eval, ...) and ``l_true``
      (K,); every epoch records ``(L_model - L_true) / max(L_true, 1e-8)``
      a member (:func:`..training._ensemble_rel_eval` builds it).
    * ``start_epoch`` / ``initial_state`` = (params_stack, optimizer state
      dicts): continue exactly where a run stopped.
    * ``chunk_len`` / ``on_chunk(next_epoch, params_stack, opt_states,
      hist_so_far)``: the checkpoint hook, after every ``chunk_len``
      epochs.
    * ``member_hparams``: (K,) ``learning_rate`` / ``weight_decay`` for a
      ``population_adam`` optimizer; they override a fresh and a resumed
      state alike.
    * ``chunked`` (default): the epochs in chunks of ``chunk_len``, each
      epoch of all members one program (:class:`_EnsembleRun`, a CUDA graph
      replay on one card without a mesh), the rows read once a chunk;
      False runs the member loop (members in turn, their rows read every
      epoch), bit for bit the same.  ``verbose``: print the "Training
      path:" line (the members' route, and the program's mode: "CUDA
      graph" or "eager: <reason>").

    ``use_pallas == "auto"`` trains on copies with ``use_pallas=False``
    (the JAX package's rule, ``:144-152``); the caller's model keeps
    ``"auto"``.  ``True`` and ``"step"`` are kept.

    Returns ``(params_stack, opt_states, hist)``, ``hist`` mapping
    ``train`` / ``val`` / ``rel`` to (n_epochs - start_epoch, K) float64
    tensors (``val`` / ``rel`` only when asked for).
    """
    work = copy.copy(model)   # shares the parameters; members deep-copy it
    if work.use_pallas == "auto":
        work.use_pallas = False
    tx = optimizer if optimizer is not None else (
        lambda p: make_adam(p, 1e-3, 5e-4))
    hparams = (_member_hparams(tx, member_hparams, n_seeds)
               if member_hparams else None)
    if initial_state is not None:
        params, opt_states = initial_state
    else:
        params, opt_states = init_ensemble(model, n_seeds, seed=seed), None
    trainer_kw = dict(ignore_first_continuity=ignore_first_continuity,
                      moment_weights=moment_weights,
                      variance_method=variance_method,
                      extended_moments=extended_moments)
    # this rank's members: their global indices, stacks, states and seeds
    mine = _seed_block(mesh, n_seeds)
    joined = mine is not None
    idx = list(range(n_seeds))[mine] if joined else list(range(n_seeds))
    if joined:
        params = shard_ensemble(mesh, params)
        opt_states = (None if opt_states is None
                      else shard_ensemble(mesh, opt_states))
        hparams = (None if hparams is None
                   else {k: v[mine] for k, v in hparams.items()})
    members = _members(work, params, opt_states, tx, hparams,
                       [_member_seeds(seed, n_seeds)[s] for s in idx],
                       trainer_kw)

    dev = model.device
    data_seeds = [_member_seeds(data_seed, n_seeds, share_data)[s]
                  for s in idx]

    def loaders(n, stream):
        return {ds: DataLoader(ds, n, process_type, obs_fraction, False,
                               process_kwargs, obs_only=obs_only,
                               stream=stream, device=dev)
                for ds in set(data_seeds)}
    train_loaders = loaders(n_trajectories, STREAM_TRAIN)
    val_data = (_member_data(loaders(n_val, STREAM_VAL), data_seeds, 0)
                if n_val > 0 else None)

    def epoch_row(e):
        out = {"train": [float(tr._epoch_update(t, v, m, e, batch_size,
                                                shuffle))
                         for tr, (t, v, m) in zip(
                             members, _member_data(train_loaders,
                                                   data_seeds, e))]}
        if val_data is not None:
            out["val"] = [tr.validate(t, v, mask=m)
                          for tr, (t, v, m) in zip(members, val_data)]
        if rel_eval is not None:
            out["rel"] = []
            with torch.no_grad():
                for s, tr in zip(idx, members):
                    l_model = float(tr._loss_no_first(
                        rel_eval["times"][s], rel_eval["values"][s],
                        rel_eval["mask"][s]))
                    out["rel"].append((l_model - l_true[s])
                                      / max(l_true[s], 1e-8))
        return out

    def state():
        sds = [tr.model.state_dict() for tr in members]
        osds = [tr.optimizer.state_dict() for tr in members]
        if joined:
            sds = [{k: v.to(dev) for k, v in sd.items()}
                   for sd in _join_members(mesh, sds, n_seeds)]
            osds = _join_members(mesh, osds, n_seeds)
        return stack_states(sds), osds

    def merged(rows):
        keys = rows[0].keys() if rows else ("train",)
        out = {}
        for k in keys:
            cols = [[r[k][j] for r in rows] for j in range(len(idx))]
            if joined:
                cols = _join_members(mesh, cols, n_seeds)
            out[k] = torch.tensor(cols, dtype=torch.float64).reshape(
                n_seeds, len(rows)).T
        return out

    if not chunk_len:
        chunk_len = max(n_epochs - start_epoch, 1)
    rows = []
    if not chunked:
        # each member's true-predictor loss, read once
        l_true = (rel_eval["l_true"].tolist() if rel_eval is not None
                  else None)
        for e in range(start_epoch, n_epochs):
            rows.append(epoch_row(e))
            done = e + 1
            if on_chunk is not None and ((done - start_epoch) % chunk_len
                                         == 0 or done == n_epochs):
                on_chunk(done, *state(), merged(rows))
        return (*state(), merged(rows))
    eager = _ensemble_decline(members, train_loaders, data_seeds, mesh)
    capture = eager is None and dev.type == "cuda"
    if verbose and start_epoch < n_epochs:
        mode = ("CUDA graph" if capture
                else f"eager: {eager or 'not on a CUDA device'}")
        tr = members[0]
        shape = train_loaders[data_seeds[0]](start_epoch).times.shape
        tr._say_route(tr._kernel_decline(batch_size, shape[1]), shape,
                      batch_size, start_epoch, report=False,
                      chunked=f", an ensemble of {n_seeds} members, chunked "
                              f"({mode})")
    run = _EnsembleRun(members, train_loaders, data_seeds, val_data,
                       rel_eval, idx, batch_size, shuffle, capture,
                       eager is None, n_epochs)
    try:
        e = start_epoch
        while e < n_epochs:
            L = min(chunk_len, n_epochs - e)
            rows += run.chunk(e, L)
            e += L
            if on_chunk is not None:
                on_chunk(e, *state(), merged(rows))
    finally:
        run.release()
    return (*state(), merged(rows))


def train_population(model: NeuralJumpODE, process_type: str,
                     learning_rates, n_epochs: int, *,
                     weight_decays=None, share_data: bool = True,
                     **kwargs):
    """K members that differ in learning rate (and weight decay), one
    ``population_adam`` each (``njode_tpu/utils/ensemble.py:298-332``).
    ``learning_rates`` (K,) sets the member count; ``weight_decays`` a
    scalar or (K,) (default 0); ``share_data=True`` (default) gives every
    member the same data, isolating the hyperparameters' effect.  Returns
    what :func:`train_ensemble_full` returns; the best member is the
    argmin of the last row."""
    lr = np.asarray(learning_rates, np.float64)
    if lr.ndim != 1:
        raise ValueError("learning_rates must be one-dimensional")
    wd = (np.zeros_like(lr) if weight_decays is None
          else np.broadcast_to(np.asarray(weight_decays, np.float64),
                               lr.shape))
    return train_ensemble_full(
        model, process_type, n_seeds=int(lr.shape[0]), n_epochs=n_epochs,
        optimizer=population_adam(), share_data=share_data,
        member_hparams={"learning_rate": lr, "weight_decay": wd}, **kwargs)


def train_ensemble(model: NeuralJumpODE, process_type: str, n_seeds: int,
                   n_epochs: int, **kwargs):
    """:func:`train_ensemble_full` without the evaluation and resume
    extras: ``(params_stack, losses)``, losses (n_epochs, K) the members'
    mean epoch losses."""
    params, _, hist = train_ensemble_full(model, process_type, n_seeds,
                                          n_epochs, **kwargs)
    return params, hist["train"]


def _member_models(model: NeuralJumpODE, params_stack: dict):
    """One copy of ``model`` holding each member's weights in turn."""
    work = copy.deepcopy(model)
    for s in range(n_members(params_stack)):
        work.load_state_dict(member_state(params_stack, s))
        yield work


def ensemble_predict(model: NeuralJumpODE, params_stack: dict, times, values,
                     mask=None):
    """Every member's ``model.apply`` on the same batch, without autograd
    (a ``dt_ode_step`` model's gaps take the gap kernel).  Returns
    ``(preds, preds_before)``, each (K, B, N, d_y, M)."""
    preds, before = [], []
    with torch.no_grad():
        for m in _member_models(model, params_stack):
            p, b = m.apply(times, values, mask)
            preds.append(p)
            before.append(b)
    return torch.stack(preds), torch.stack(before)


def ensemble_mean_std(preds: torch.Tensor):
    """Epistemic (seed) uncertainty: the mean and the population std
    (``jnp.std``'s, no Bessel correction) over the member axis."""
    return preds.mean(dim=0), preds.std(dim=0, correction=0)


def seed_bands(model: NeuralJumpODE, params_stack: dict, grid_times,
               obs_mask, path_values) -> dict:
    """The arrays of plotting's seed bands
    (``njode_tpu/utils/plotting.py:158-166``): every member's
    ``predict_on_grid`` on path 0, as numpy.  ``member_means`` (K, G), their
    ``mean`` and population ``seed_std`` (G,), and ``var`` (G,), the
    members' mean variance, or None for a one-moment model."""
    means, variances = [], []
    for m in _member_models(model, params_stack):
        out = m.predict_on_grid(grid_times, obs_mask, path_values)
        means.append(out["mean"][0, :, 0].cpu().numpy())
        if out["var"] is not None:
            variances.append(out["var"][0, :, 0].cpu().numpy())
    member_means = np.stack(means)
    return {"member_means": member_means, "mean": member_means.mean(axis=0),
            "seed_std": member_means.std(axis=0),
            "var": np.stack(variances).mean(axis=0) if variances else None}
