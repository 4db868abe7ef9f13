"""Training: Adam, data loaders, the Trainer and ``run_experiment`` (port of
``njode_tpu.utils.training``).

* The optimizer is ``torch.optim.Adam(lr, weight_decay)``: L2 decay added to
  the gradient before the moments, the law the JAX package's ``make_adam``
  reproduces with optax.
* Data: :class:`DataLoader` simulates a batch on the model's device from an
  explicit ``torch.Generator``.  The generator of an epoch is seeded from
  (base_seed, stream, epoch) alone by :func:`stream_seed`; the validation
  loader is always cached, and training epochs are fresh unless
  ``cache_data`` is set.
* :class:`Trainer` runs an epoch either on the composed path (``apply`` +
  the loss + autograd + Adam, one step per minibatch: shuffled, the last
  minibatch padded and trajectory-masked) or, with ``use_train_kernel``, as
  one call of a whole-run kernel (the CUDA kernel on the card, its plain
  version on the CPU), converting the Adam state at each call, so
  checkpoints of either path resume on the other.  The model's recipe picks
  the twin, as in the JAX package: without ``dt_ode_step``
  :func:`njode_tpu_torch.ops.fused_train_run`, with it (and the grid walk)
  the walk twin :func:`njode_tpu_torch.ops.fused_walk_train_run`.  Both
  paths see the same minibatches: the shuffle of an epoch comes from
  (seed, epoch).
* ``Trainer.train(..., chunk_epochs="auto")`` (the JAX package's default
  for its data loaders, and so ``run_experiment``'s) runs the epochs of a
  :class:`DataLoader` in chunks that end on print boundaries, reading the
  losses once a chunk and writing a checkpoint at each chunk's end
  (:meth:`Trainer._train_chunked`).  On one card every route replays each
  epoch as a CUDA graph (:mod:`.chunked`), registered processes' draws
  included; every loss and the final state equal the per-epoch loop's bit
  for bit.
* Checkpoints keep the reference's semantics: ``start_epoch =
  len(train_losses)``, an early return when training is complete, a fresh
  start when the checkpoint cannot be loaded (reference
  utils/training.py:146-174).
* :func:`run_experiment` writes ``runs/<name>/{config.json, model.ckpt,
  history.json}`` and resolves the grid walk (:func:`_use_grid_walk`).
  ``use_pallas="step"`` (the scaled recipe) trains on the composed path
  with the model's fused-step kernels, and ``use_pallas=True`` (the CLI's
  ``--kernels force``) on the composed path with the model's forced
  per-gap kernels (the gap loop's training pair, the fused Euler cell);
  both keep the whole-run kernels off.  ``train_kernel_mxu`` reaches the
  Trainer as ``train_kernel_opts={"mxu_dtype": ...}``: "bfloat16" runs the
  whole-run kernels' bf16 products (rows 11b-12b, 13b); the composed path
  ignores it, as the JAX package's does.  Every process family of
  ``simulation`` trains, and registered processes too.  ``ensemble`` K > 1
  or ``ensemble_lrs`` trains K members (:func:`_run_ensemble_experiment`,
  on :mod:`.ensemble`).  ``data_parallel`` N, ``multihost`` or a process
  group that exists (torchrun) train data-parallel over ranks
  (:mod:`njode_tpu_torch.parallel`): every rank draws the same epoch and
  shuffle, keeps its rows of each minibatch, back-propagates its share of
  the global masked mean, and the gradients are summed before every Adam
  step; an ensemble spreads its members over the ranks' model axis.
  ``model_parallel`` M > 1 adds the mesh's model axis
  (:mod:`njode_tpu_torch.parallel.model_axis`): ``model_parallel_mode``
  "moments" (the default) puts each rank's block of the K separate
  networks on it, "hidden" the row blocks of the weights; D x M ranks run,
  the gradients summed over the data axis alone.  The whole-run kernels and
  the grid walk decline under a mesh, as in the JAX package.  Pallas
  interpret mode is not ported and raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models import NeuralJumpODE, nj_ode_loss_dense, pad_ragged
from ..models.jump_ode import DeferredGuards, resolve_device
from ..simulation import TrajectoryBatch, simulate_batch
from ..simulation.moments import moments_at_obs
from .checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint

RELATIVE_LOSS_PROCESSES = ("black_scholes", "ornstein_uhlenbeck", "heston",
                           "hybrid_ou_bs")

# generator streams of stream_seed; STREAM_MEMBER derives an ensemble
# member's seeds (utils/ensemble.py), its "epoch" the member's index
STREAM_TRAIN, STREAM_VAL, STREAM_SHUFFLE, STREAM_DROPOUT = 0, 1, 2, 3
STREAM_MEMBER = 4
# STREAM_RANK folds a rank's index into an epoch's dropout seed;
# STREAM_NETWORK a separate network's index (its own dropout stream)
STREAM_RANK = 5
STREAM_NETWORK = 6


def make_adam(params, learning_rate: float,
              weight_decay: float = 0.0) -> torch.optim.Adam:
    """``torch.optim.Adam(lr, weight_decay)``: L2 into the gradient, then
    Adam with betas (0.9, 0.999) and eps 1e-8 (the JAX ``make_adam``,
    ``njode_tpu/utils/training.py:66``).  Parameters on the card get
    ``capturable=True`` (the step count and the bias corrections on the
    device), so the chunked route can capture its steps in a CUDA graph;
    the update is the same law, its last bits may differ from the host's
    step arithmetic."""
    params = list(params)
    tensors = [p for g in params
               for p in (g["params"] if isinstance(g, dict) else [g])]
    capturable = bool(tensors) and all(p.is_cuda for p in tensors)
    return torch.optim.Adam(params, lr=learning_rate,
                            weight_decay=weight_decay, capturable=capturable)


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_seed(base_seed: int, stream: int, epoch: int) -> int:
    """The seed of one generator: SplitMix64 folded over (base_seed, stream,
    epoch), ``s = mix(mix(mix(base_seed) ^ stream) ^ epoch)``, cut to 63
    bits.  Nothing else enters, so epoch e of a stream is the same on every
    run and after every resume."""
    s = _splitmix64(int(base_seed) & _M64)
    s = _splitmix64(s ^ int(stream))
    s = _splitmix64(s ^ int(epoch))
    return s & ((1 << 63) - 1)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# --------------------------------------------------------------------------
# data loaders
# --------------------------------------------------------------------------

class DataLoader:
    """Simulates a :class:`TrajectoryBatch` per epoch on ``device``, or one
    batch for all epochs when ``cache`` is set."""

    def __init__(self, seed: int, n_trajectories: int, process_type: str,
                 obs_fraction: float, cache: bool, process_kwargs: dict,
                 obs_only: bool = False, stream: int = STREAM_TRAIN,
                 device=None):
        self.seed = seed
        self.n_trajectories = n_trajectories
        self.process_type = process_type
        self.obs_fraction = obs_fraction
        self.cache = cache
        self.process_kwargs = dict(process_kwargs)
        self.obs_only = obs_only
        self.stream = stream
        self.device = resolve_device(device)
        self._cached: Optional[TrajectoryBatch] = None

    def seed_of(self, epoch: int) -> int:
        """The seed of epoch ``epoch``'s generator."""
        return stream_seed(self.seed, self.stream, epoch)

    def generate(self, generator: torch.Generator) -> TrajectoryBatch:
        """A batch drawn from ``generator`` (seeded by the caller)."""
        return simulate_batch(self.n_trajectories, self.process_type,
                              self.obs_fraction, self.obs_only,
                              generator=generator, device=self.device,
                              **self.process_kwargs)

    def _gen(self, epoch: int) -> TrajectoryBatch:
        return self.generate(_generator(self.device, self.seed_of(epoch)))

    def __call__(self, epoch: int = 0) -> TrajectoryBatch:
        if self.cache:
            if self._cached is None:
                self._cached = self._gen(0)
            return self._cached
        return self._gen(epoch)


def create_data_loaders(process_type: str = "black_scholes",
                        n_train: int = 100, n_val: int = 20,
                        obs_fraction: float = 0.1, cache_data: bool = True,
                        base_seed: int = 0, obs_only: bool = False,
                        device=None, **process_kwargs):
    """Training and validation loaders (reference utils/training.py:311-346);
    the validation loader is always cached."""
    train_fn = DataLoader(base_seed, n_train, process_type, obs_fraction,
                          cache_data, process_kwargs, obs_only=obs_only,
                          stream=STREAM_TRAIN, device=device)
    val_fn = DataLoader(base_seed, n_val, process_type, obs_fraction, True,
                        process_kwargs, obs_only=obs_only, stream=STREAM_VAL,
                        device=device)
    return train_fn, val_fn


def _call_data_fn(fn: Callable, epoch: int):
    if isinstance(fn, DataLoader):
        return fn(epoch)
    try:
        if len(inspect.signature(fn).parameters) >= 1:
            return fn(epoch)
    except (TypeError, ValueError):
        pass
    return fn()


def as_dense(data, device) -> tuple:
    """TrajectoryBatch, ragged (times, values) lists or a dense
    (times, values) pair -> (times, values, mask, batch or None) on
    ``device``."""
    if isinstance(data, TrajectoryBatch):
        return (data.times.to(device), data.values.to(device),
                data.mask.to(device), data)
    if isinstance(data, tuple) and len(data) == 2:
        bt, bv = data
        if isinstance(bt, (list, tuple)):
            t, v, m = pad_ragged(bt, bv, device=device)
            return t, v, m, None
        t = torch.as_tensor(bt, dtype=torch.float32, device=device)
        v = torch.as_tensor(bv, dtype=torch.float32, device=device)
        return t, v, torch.ones(t.shape, dtype=torch.bool, device=device), None
    raise TypeError(f"Unsupported data batch type: {type(data)}")


# --------------------------------------------------------------------------
# Trainer
# --------------------------------------------------------------------------

class Trainer:
    """Model, optimizer and histories, and the epoch loop (the reference
    Trainer's surface, utils/training.py:15-308).

    ``use_train_kernel``: ``"auto"`` takes the whole-run kernel wherever the
    model is on CUDA and its check passes (:meth:`_train_kernel_check`, or
    :meth:`_walk_train_check` for the walk twin of a ``dt_ode_step``
    model), the composed path otherwise; ``True`` takes the kernel and
    raises where the configuration is not eligible (on CPU tensors the
    kernel's plain version runs); ``False`` (default) takes the composed
    path.

    ``train_kernel_opts`` (the JAX package's name): ``mxu_dtype``
    "float32" (default) or "bfloat16", the whole-run kernels' product
    operands; ``lr``, ``weight_decay``, ``adam_eps`` (Adam's ``eps``) and
    ``betas``, where given, must equal the optimizer's (the kernels read
    every hyperparameter from its one param group).  The composed path
    ignores them.

    ``model_shard`` (``njode_tpu/utils/training.py:273-309``): "none",
    "moments" or "hidden", what the mesh's model axis holds of the model
    and its optimizer state (:class:`~njode_tpu_torch.parallel.model_axis.
    ModelShard`).  The optimizer is rebuilt over the tensors this rank
    steps, with its one param group's hyperparameters.  Separate networks
    draw dropout from a stream each (``STREAM_NETWORK``), so placement
    changes no mask: a network draws the same masks under any
    ``model_shard`` and at any model axis, one process (no mesh) included.
    """

    def __init__(self, model: NeuralJumpODE,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 device=None, ignore_first_continuity: bool = False,
                 moment_weights: Optional[List[float]] = None,
                 variance_method: str = "direct",
                 extended_moments: bool = False, mesh=None, seed: int = 0,
                 checkpoint_backend: str = "msgpack", use_train_kernel=False,
                 train_kernel_opts: Optional[Dict] = None,
                 model_shard: str = "none"):
        asked = None if device in (None, "auto") else torch.device(device)
        if asked is not None and (
                asked.type != model.device.type
                or asked.index not in (None, model.device.index)):
            raise ValueError(f"Trainer(device={device!r}) but the model lives "
                             f"on {model.device}; the Trainer follows the "
                             "model's device")
        if use_train_kernel == "interpret":
            raise ValueError("use_train_kernel='interpret' has no port: the "
                             "kernel's plain version is what CPU tensors take "
                             "(use True with a CPU model)")
        if use_train_kernel not in (False, True, "auto"):
            raise ValueError(f"Unknown use_train_kernel: {use_train_kernel!r}")
        if mesh is not None and mesh.device != model.device:
            raise ValueError(f"the model lives on {model.device}, this "
                             f"rank's device is {mesh.device}")
        if model_shard not in ("none", "moments", "hidden"):
            raise ValueError(f"Unknown model_shard: {model_shard!r} "
                             "(one of 'none', 'moments', 'hidden')")
        self.model = model
        self.device = model.device
        self.optimizer = (optimizer if optimizer is not None
                          else make_adam(model.parameters(), 1e-3))
        # a step that keeps the parameters' versions (a fused Adam) would
        # leave the model's cut of the inference weights stale
        self.optimizer.register_step_post_hook(model._drop_gap_cache)
        self.ignore_first_continuity = ignore_first_continuity
        self.moment_weights = list(moment_weights) if moment_weights else None
        self.variance_method = variance_method
        self.extended_moments = extended_moments
        self.seed = seed
        self.use_train_kernel = use_train_kernel
        self.train_kernel_opts = dict(train_kernel_opts or {})
        self.checkpoint_backend = checkpoint_backend
        # data parallelism (parallel/mesh.py): every rank holds the model,
        # rank 0's weights broadcast here, and the same full epoch; each
        # keeps its rows of a minibatch and the gradients are summed over
        # the data axis.  The model axis (parallel/model_axis.py): each rank
        # keeps its part of the model and steps it alone
        self.mesh = mesh
        self.model_shard = model_shard
        self.grad_reductions = 0      # all-reduces of a step's gradients
        self.shard = None
        if mesh is not None:
            from ..parallel import shard_params
            shard_params(mesh, model)
        if model_shard != "none" and mesh is not None and mesh.n_model > 1:
            from ..parallel.model_axis import ModelShard
            self.shard = ModelShard(mesh, model, model_shard)
            self.optimizer = _rebuilt(self.optimizer, self.shard.params())
            self.optimizer.register_step_post_hook(model._drop_gap_cache)
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self.epoch_times: List[float] = []
        self.relative_losses: List[float] = []
        self._epochs_run = 0          # epoch index of train_epoch calls
        # the chunked route on the card: run every epoch of a chunk under
        # torch.cuda.set_sync_debug_mode("error") (a check, not a default)
        self.check_syncs = False
        self._chunk_run: Optional[_ChunkRun] = None

    # ------------------------------------------------------------- loss fn

    def _loss(self, times, values, mask, traj_mask=None, generator=None,
              training=False):
        return self.model.apply_loss(
            times, values, mask, generator=generator, training=training,
            ignore_first_continuity=self.ignore_first_continuity,
            moment_weights=self.moment_weights,
            variance_method=self.variance_method, traj_mask=traj_mask,
            extended_moments=self.extended_moments)

    # ----------------------------------------------------------- an epoch

    def _minibatches(self, epoch: int, n: int, batch_size: int,
                     shuffle: bool,
                     generator: Optional[torch.Generator] = None):
        """(nb, bs) trajectory indices and validity of an epoch: a
        permutation from (seed, epoch), or from ``generator`` seeded so by
        the caller, padded at the end with index 0."""
        dev = self.device
        if shuffle:
            gen = (generator if generator is not None else _generator(
                dev, stream_seed(self.seed, STREAM_SHUFFLE, epoch)))
            perm = torch.randperm(n, generator=gen, device=dev)
        else:
            perm = torch.arange(n, device=dev)
        nb = -(-n // batch_size)
        n_pad = nb * batch_size
        idx = torch.cat([perm, torch.zeros(n_pad - n, dtype=perm.dtype,
                                           device=dev)])
        valid = torch.arange(n_pad, device=dev) < n
        return idx.reshape(nb, batch_size), valid.reshape(nb, batch_size)

    def _dropout_generator(self, epoch: int, sharded: bool = False):
        """An epoch's dropout stream, from (seed, epoch); where the ranks
        hold different rows, from (seed, epoch, rank), so ranks never share
        masks.  Ranks that each hold every row draw the same masks, so their
        replicas stay equal without a reduction.  Separate networks get a
        list: one stream a network, from that seed and the network's index
        among all K, so network k draws the same masks whatever rank holds
        it and at any model axis, one process included."""
        seeds = self._dropout_seeds(epoch, sharded)
        if seeds is None:
            return None
        if isinstance(seeds, int):
            return _generator(self.device, seeds)
        return [_generator(self.device, s) for s in seeds]

    def _dropout_seeds(self, epoch: int, sharded: bool = False):
        """The seeds of :meth:`_dropout_generator`: None without dropout,
        one seed for a shared network, a list of one a separate network."""
        m = self.model
        if m.dropout_rate <= 0.0:
            return None
        seed = stream_seed(self.seed, STREAM_DROPOUT, epoch)
        if sharded:
            seed = stream_seed(seed, STREAM_RANK, self.mesh.data_rank)
        if m.shared_network:
            return seed
        lo = m._moments[0] if m._moments is not None else 0
        return [stream_seed(seed, STREAM_NETWORK, k)
                for k in range(lo, lo + m.local_moments)]

    def _rows(self, rows: int) -> Optional[slice]:
        """This rank's rows of a minibatch of ``rows``, or None where it
        holds them all (no mesh, or a data axis that does not divide
        them)."""
        from ..parallel.mesh import shard_rows
        return shard_rows(self.mesh, rows)

    def _shard_loss(self, loss_fn, times, values, mask, traj_mask, sl):
        """The loss of this rank's rows ``sl`` as its share of the global
        masked mean: its masked mean times its valid rows over the whole
        minibatch's, so the sum over ranks is the mean over every valid
        row.  ``loss_fn(times, values, mask, traj_mask)``."""
        loss = loss_fn(times[sl], values[sl], mask[sl],
                       None if traj_mask is None else traj_mask[sl])
        if traj_mask is None:
            return loss * ((sl.stop - sl.start) / times.shape[0])
        tm = traj_mask.to(loss.dtype)
        return loss * (tm[sl].sum() / torch.clamp_min(tm.sum(), 1.0))

    def _reduce_grads(self) -> None:
        """Sum the gradients of what this rank steps over the data axis (one
        flat all-reduce): the ranks of a data group hold the same part of
        the model.  Every rank ran the same graph, so the same parameters
        hold a gradient."""
        from ..parallel.mesh import all_reduce_sum
        all_reduce_sum([p.grad for g in self.optimizer.param_groups
                        for p in g["params"] if p.grad is not None],
                       group=self.mesh.data_group)
        self.grad_reductions += 1

    def _step(self, times, values, mask, traj_mask, gen) -> torch.Tensor:
        """One Adam step on a minibatch; returns its loss (this rank's
        share where the ranks split the rows)."""
        opt = self.optimizer
        opt.zero_grad(set_to_none=True)

        def loss_fn(t, v, m, tm):
            return self._loss(t, v, m, traj_mask=tm, generator=gen,
                              training=True)
        sl = self._rows(times.shape[0])
        if sl is None:
            loss = loss_fn(times, values, mask, traj_mask)
        else:
            loss = self._shard_loss(loss_fn, times, values, mask, traj_mask,
                                    sl)
        loss.backward()
        if self.shard is not None:
            self.shard.after_backward()
        if sl is not None:
            self._reduce_grads()
        opt.step()
        if self.shard is not None:
            self.shard.after_step()
        return loss.detach()

    def _epoch_update(self, times, values, mask, epoch: int,
                      batch_size: Optional[int], shuffle: bool,
                      streams: Optional["_Streams"] = None) -> torch.Tensor:
        """One composed epoch: a step of apply + loss + autograd + Adam per
        minibatch (reference utils/training.py:33-103).  Returns the mean of
        the minibatch losses, on the device.  Under a mesh every rank runs
        the same minibatches, each on its rows, with the gradients summed
        before every step.  ``streams``: the chunked route's generators,
        seeded for this epoch (else they are made from ``epoch``)."""
        n = times.shape[0]
        self.model.train()
        if batch_size is None or batch_size >= n:
            sharded = self._rows(n) is not None
            gen = (streams.dropout if streams is not None
                   else self._dropout_generator(epoch, sharded))
            loss = self._step(times, values, mask, None, gen)
            return self._sum_over_ranks(loss) if sharded else loss
        idx, valid = self._minibatches(
            epoch, n, batch_size, shuffle,
            streams.shuffle if streams is not None else None)
        sharded = self._rows(batch_size) is not None
        gen = (streams.dropout if streams is not None
               else self._dropout_generator(epoch, sharded))
        losses = torch.stack([
            self._step(times[ids], values[ids], mask[ids], vm, gen)
            for ids, vm in zip(idx, valid)])
        if sharded:
            losses = self._sum_over_ranks(losses)
        return losses.mean()

    def _sum_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data axis (the ranks of a model group
        hold the same rows and the same share)."""
        from ..parallel.mesh import all_reduce_sum
        x = x.clone()
        all_reduce_sum([x], group=self.mesh.data_group)
        return x

    def _kernel_hparams(self) -> dict:
        g = self.optimizer.param_groups[0]
        return {"lr": float(g["lr"]), "weight_decay": float(g["weight_decay"]),
                "betas": tuple(float(b) for b in g["betas"]),
                "adam_eps": float(g["eps"])}

    def _twin(self) -> str:
        """The whole-run kernel of the model's recipe: "walk" with
        ``dt_ode_step`` (``njode_tpu/utils/training.py:951``), else "run"."""
        return "walk" if self.model.dt_ode_step is not None else "run"

    def _kernel_kw(self, n_slots: int, batch_size: int) -> dict:
        """The whole-run kernel's keyword arguments for the model's twin
        (the walk twin's with its grid)."""
        m = self.model
        hp = self._kernel_hparams()
        mw = tuple(self.moment_weights) if self.moment_weights else (1.0, 1.0)
        kw = dict(n_slots=n_slots, num_moments=m.num_moments,
                  batch_size=batch_size, activation=m._act_key,
                  input_scaling=m._scale_key, lr=hp["lr"],
                  weight_decay=hp["weight_decay"], moment_weights=mw,
                  variance_method=self.variance_method, betas=hp["betas"],
                  adam_eps=hp["adam_eps"], mxu_dtype=self._mxu_dtype())
        if self._twin() == "walk":
            kw.update(hidden_dim=m.hidden_dim, dt_ode_step=m.dt_ode_step,
                      max_substeps=walk_cells(m), ode_solver=m.ode_solver)
        return kw

    def _kernel_epoch(self, times, values, epoch: int,
                      batch_size: Optional[int], shuffle: bool
                      ) -> torch.Tensor:
        """One epoch as one call of the whole-run kernel of the model's
        twin (the plain version for a CPU model), the Adam state converted
        in and out.  The same minibatches as :meth:`_epoch_update`.  The
        kernels take every slot as an observation: :meth:`train` sends them
        only batches whose mask is full; the walk twin checks that the
        times sit on the grid, as the composed walk does."""
        from ..ops import train_kernel as tk
        from ..ops import walk_train as wt
        m = self.model
        n = times.shape[0]
        bs = batch_size if batch_size is not None else n
        idx, valid = self._minibatches(epoch, n, bs, shuffle)
        ids = idx.reshape(-1)
        data = tk.pack_minibatches(times[ids], values[ids], valid.reshape(-1),
                                   bs)
        kw = self._kernel_kw(times.shape[1], bs)
        opt_sd = self.optimizer.state_dict()
        with torch.no_grad():
            if self._twin() == "walk":
                m._check_grid_alignment(times, None)
                state = wt.walk_state_from(m, opt_sd, betas=kw["betas"])
                state, losses = wt.fused_walk_train_run(state, data, **kw)
                sd, osd = wt.optax_state_into_walk(state, idx.shape[0],
                                                   opt_sd, m)
            else:
                state = tk.kernel_state_from(m, opt_sd, betas=kw["betas"])
                state, losses = tk.fused_train_run(state, data, **kw)
                sd, osd = tk.optax_state_into(state, idx.shape[0], opt_sd, m)
            m.load_state_dict(sd)
            self.optimizer.load_state_dict(osd)
        return losses.mean()

    def train_epoch(self, batch_times, batch_values,
                    batch_size: Optional[int] = None, shuffle: bool = True,
                    mask=None) -> float:
        """Train one composed epoch (reference utils/training.py:33-103)."""
        if isinstance(batch_times, (list, tuple)):
            times, values, mask_, _ = as_dense((batch_times, batch_values),
                                               self.device)
        else:
            times, values, _, _ = as_dense((batch_times, batch_values),
                                           self.device)
            mask_ = (torch.ones(times.shape, dtype=torch.bool,
                                device=self.device)
                     if mask is None else mask.to(self.device))
        loss = self._epoch_update(times, values, mask_, self._epochs_run,
                                  batch_size, shuffle)
        self._epochs_run += 1
        return float(loss)

    # ------------------------------------------------------------ validate

    def validate(self, batch_times, batch_values, mask=None) -> float:
        """Full-batch evaluation loss (reference utils/training.py:105-124),
        without autograd: eligible gaps take the gap kernel."""
        if isinstance(batch_times, (list, tuple)):
            times, values, mask_, _ = as_dense((batch_times, batch_values),
                                               self.device)
        else:
            times, values, _, _ = as_dense((batch_times, batch_values),
                                           self.device)
            mask_ = (torch.ones(times.shape, dtype=torch.bool,
                                device=self.device)
                     if mask is None else mask.to(self.device))
        with torch.no_grad():
            return float(self._eval_loss(
                lambda t, v, m, tm: self._loss(t, v, m, traj_mask=tm),
                times, values, mask_))

    def _eval_loss(self, loss_fn, times, values, mask) -> torch.Tensor:
        """An evaluation loss over a whole batch; under a mesh each rank
        takes its rows and the shares are summed (the global mean)."""
        sl = self._rows(times.shape[0])
        if sl is None:
            return loss_fn(times, values, mask, None)
        return self._sum_over_ranks(
            self._shard_loss(loss_fn, times, values, mask, None, sl))

    # ----------------------------------------------------- relative loss

    def _setup_relative_loss(self, train_data_fn, config):
        """A fixed 10-trajectory batch of epoch 0 and its closed-form truths
        (reference utils/training.py:184-196,219-255); None for a process
        with no truths (neither a built-in family nor a registered
        ``moments_fn``).  With ``exact_hybrid_truths`` a hybrid batch with
        random switch times takes the recorded ones
        (``njode_tpu/utils/training.py:836-857``); without it the truths
        are zero, as the reference's."""
        data_cfg = config["data"]
        process_type = data_cfg["process_type"]
        from ..simulation.registry import get_moments_fn
        if (process_type not in RELATIVE_LOSS_PROCESSES
                and get_moments_fn(process_type) is None):
            return None
        times, values, mask, tb = as_dense(_call_data_fn(train_data_fn, 0),
                                           self.device)
        times, values, mask = times[:10], values[:10], mask[:10]
        params = {k: v for k, v in data_cfg.items() if k != "process_type"}
        switch_times = None
        if (process_type == "hybrid_ou_bs"
                and data_cfg.get("switch_time") is None
                and tb is not None and tb.switch_times is not None
                and config.get("exact_hybrid_truths", False)):
            switch_times = tb.switch_times[:10].to(self.device)
        y_true, y_true_before = moments_at_obs(
            times, values, process_type, num_moments=self.model.num_moments,
            variance_method=self.variance_method, mask=mask,
            switch_times=switch_times, **params)
        return dict(times=times, values=values, mask=mask, y_true=y_true,
                    y_true_before=y_true_before)

    def _loss_no_first(self, times, values, mask):
        # evaluation keeps ignore_first_continuity=False, like the
        # reference's eval-time nj_ode_loss calls (:225-227, :250)
        return self.model.apply_loss(
            times, values, mask, moment_weights=self.moment_weights,
            variance_method=self.variance_method,
            extended_moments=self.extended_moments)

    def compute_relative_loss(self, rel) -> float:
        with torch.no_grad():
            L_model = float(self._eval_loss(
                lambda t, v, m, tm: self._loss_no_first(t, v, m),
                rel["times"], rel["values"], rel["mask"]))
            L_true = float(nj_ode_loss_dense(
                rel["values"], rel["y_true"], rel["y_true_before"],
                rel["mask"], moment_weights=self.moment_weights,
                variance_method=self.variance_method,
                extended_moments=self.extended_moments))
        return (L_model - L_true) / max(L_true, 1e-8)

    # -------------------------------------------------- kernel eligibility

    def _train_kernel_check(self, batch_size: Optional[int],
                            n_slots: Optional[int] = None,
                            mask: Optional[torch.Tensor] = None) -> None:
        """Raise, listing every problem, when the whole-run kernel cannot
        train this setup."""
        problems = self._train_kernel_problems(batch_size, n_slots, mask)
        if problems:
            raise ValueError("train kernel not applicable: "
                             + "; ".join(problems))

    def _walk_train_check(self, batch_size: Optional[int],
                          n_slots: Optional[int] = None,
                          mask: Optional[torch.Tensor] = None) -> None:
        """Raise, listing every problem, when the walk-train kernel cannot
        train this setup."""
        problems = self._walk_train_problems(batch_size, n_slots, mask)
        if problems:
            raise ValueError("train kernel (walk twin) not applicable: "
                             + "; ".join(problems))

    def _train_kernel_problems(self, batch_size: Optional[int],
                               n_slots: Optional[int] = None,
                               mask: Optional[torch.Tensor] = None) -> list:
        """Every reason the whole-run kernel cannot train this setup
        (``njode_tpu/utils/training.py:379-416``, with the port's own gates
        on the shapes and on the batch's ``mask``)."""
        from ..ops.train_kernel import (MAX_HIDDEN, batch_size_ok,
                                        kernel_fits, train_kernel_available)
        m = self.model
        problems = []
        if not train_kernel_available(
                m.shared_network, m.input_dim, m.output_dim,
                m.n_hidden_layers, m._act_key, m.dropout_rate, m._scale_key,
                m.dt_ode_step, m.ode_solver):
            problems.append(
                "model config (needs separate networks, input/output dim 1, "
                "one hidden layer, no dropout, euler, no dt_ode_step, an "
                "f(0)=0 activation/scaling)")
        if m.num_moments not in (1, 2):
            problems.append("num_moments must be 1 or 2 (the kernel's "
                            "closed-form loss covers mean and mean+variance)")
        if m.hidden_dim > MAX_HIDDEN:
            problems.append(f"hidden_dim must be <= {MAX_HIDDEN}")
        elif n_slots is not None and not kernel_fits(m.hidden_dim, n_slots,
                                                      m._scale_key):
            problems.append(f"hidden_dim {m.hidden_dim} with {n_slots} "
                            "observation slots does not fit the kernel "
                            "(at least 2 slots, one warp's working set in "
                            "shared memory)")
        # the kernel computes float32: a compute dtype would be dropped
        # (njode_tpu/utils/training.py:400)
        if m.dtype != torch.float32 or m.compute_dtype is not None:
            problems.append("float32 only")
        if not self.ignore_first_continuity:
            problems.append("ignore_first_continuity must be enabled")
        if self.extended_moments:
            problems.append("extended_moments unsupported")
        if self.mesh is not None:
            problems.append("data/model-parallel meshes unsupported")
        if not batch_size_ok(batch_size):
            problems.append("batch_size must be given (a positive integer)")
        if mask is not None and not bool(mask.all()):
            problems.append("the batch has padded slots (its mask is not "
                            "all True); the kernel takes every slot as an "
                            "observation")
        return problems + self._kernel_opts_problems()

    def _walk_train_problems(self, batch_size: Optional[int],
                             n_slots: Optional[int] = None,
                             mask: Optional[torch.Tensor] = None) -> list:
        """Every reason the walk-train kernel cannot train this setup
        (``njode_tpu/utils/training.py:461-512``, with the port's own shape
        gate and the batch's ``mask``)."""
        from ..ops.walk_train import (MAX_BATCH, MAX_HIDDEN,
                                      walk_train_available,
                                      walk_train_shapes_ok)
        m = self.model
        problems = []
        if not walk_train_available(
                m.shared_network, m.input_dim, m.output_dim,
                m.n_hidden_layers, m._act_key, m.dropout_rate, m._scale_key,
                m.dt_ode_step, m.ode_solver):
            problems.append(
                "model config (needs a shared network, input/output dim 1, "
                "one hidden layer, no dropout, euler/heun/rk4, "
                "dt_ode_step)")
        if not m.grid_walk:
            problems.append(
                "grid_walk off: the kernel integrates on the fixed "
                "{g*dt_ode_step} grid, so grid_walk must resolve on "
                "(grid-aligned observation times)")
        if m.num_moments not in (1, 2):
            problems.append("num_moments must be 1 or 2 (the kernel's "
                            "closed-form loss covers mean and mean+variance)")
        # as the run twin (njode_tpu/utils/training.py:489)
        if m.dtype != torch.float32 or m.compute_dtype is not None:
            problems.append("float32 only")
        if not self.ignore_first_continuity:
            problems.append("ignore_first_continuity must be enabled")
        if self.extended_moments:
            problems.append("extended_moments unsupported")
        if self.mesh is not None:
            problems.append("data/model-parallel meshes unsupported")
        if not walk_train_shapes_ok(m.hidden_dim, batch_size,
                                    n_slots if n_slots is not None else 2,
                                    walk_cells(m), m.ode_solver):
            problems.append(
                f"shapes (needs 1 <= hidden_dim <= {MAX_HIDDEN}, 1 <= "
                f"batch_size <= {MAX_BATCH}, at least 2 observation slots "
                "and one grid cell, the block's working set in shared "
                f"memory; got hidden {m.hidden_dim}, batch {batch_size}, "
                f"n_slots {n_slots}, {walk_cells(m)} cells)")
        if mask is not None and not bool(mask.all()):
            problems.append("the batch has padded slots (its mask is not "
                            "all True); the kernel takes every slot as an "
                            "observation")
        return problems + self._kernel_opts_problems()

    def _mxu_dtype(self) -> str:
        return self.train_kernel_opts.get("mxu_dtype", "float32")

    def _kernel_opts_problems(self) -> list:
        """The kernel implements ``torch.optim.Adam`` with L2 weight decay
        and reads its hyperparameters from the optimizer's one param group;
        ``train_kernel_opts`` names a known ``mxu_dtype`` and no ``lr``,
        ``weight_decay``, ``adam_eps`` or ``betas`` other than the
        optimizer's (``njode_tpu/utils/training.py:417-458``)."""
        from ..ops.train_kernel import MXU_DTYPES
        problems = []
        mxu = self._mxu_dtype()
        if mxu not in MXU_DTYPES:
            problems.append(f"train_kernel_opts['mxu_dtype']={mxu!r} must "
                            "be 'float32' or 'bfloat16'")
        opt = self.optimizer
        if type(opt) is not torch.optim.Adam:
            return problems + [f"the optimizer is {type(opt).__name__}; the "
                               "kernel implements torch.optim.Adam"]
        if len(opt.param_groups) != 1:
            problems.append("one optimizer param group only")
        group = opt.param_groups[0]
        for flag in ("amsgrad", "maximize", "decoupled_weight_decay"):
            if group.get(flag, False):
                problems.append(f"Adam {flag}=True unsupported")
        for k, name in (("lr", "lr"), ("weight_decay", "weight_decay"),
                        ("adam_eps", "eps")):
            got = self.train_kernel_opts.get(k)
            if got is not None and float(got) != float(group[name]):
                problems.append(f"train_kernel_opts[{k!r}]={got} != the "
                                f"optimizer's {k}={group[name]}")
        got_b = self.train_kernel_opts.get("betas")
        if got_b is not None and (tuple(map(float, got_b))
                                  != tuple(map(float, group["betas"]))):
            problems.append(f"train_kernel_opts['betas']={got_b} != the "
                            f"optimizer's betas={group['betas']}")
        return problems

    def _use_kernel(self, batch_size: Optional[int], n_slots: int,
                    mask: Optional[torch.Tensor] = None) -> bool:
        """Resolve ``use_train_kernel`` for a batch of this run, with the
        check of the model's twin."""
        return self._kernel_decline(batch_size, n_slots, mask) is None

    def _kernel_decline(self, batch_size: Optional[int], n_slots: int,
                        mask: Optional[torch.Tensor] = None
                        ) -> Optional[str]:
        """None where the whole-run kernel of the model's twin trains a
        batch of this run, else the first reason it does not.  Under
        ``use_train_kernel=True`` a setup it cannot train raises, listing
        every problem."""
        if self.use_train_kernel is False:
            return "--kernels is not 'train' or 'auto'"
        walk = self._twin() == "walk"
        if self.use_train_kernel != "auto":
            (self._walk_train_check if walk else self._train_kernel_check)(
                batch_size, n_slots, mask)
            return None
        if self.device.type != "cuda":
            return "not on a CUDA device"
        problems = (self._walk_train_problems if walk
                    else self._train_kernel_problems)(batch_size, n_slots,
                                                      mask)
        return problems[0] if problems else None

    # ---------------------------------------------------------------- train

    def _say(self, *args, **kw) -> None:
        """print on the primary rank (every print without a mesh)."""
        from ..parallel import is_primary
        if is_primary():
            print(*args, **kw)

    def _step_rows(self, n: int, batch_size: Optional[int]) -> int:
        """The rows a training step gives the model: a minibatch (every
        minibatch has ``batch_size`` rows, ``_minibatches`` pads), or this
        rank's share of it under a mesh."""
        rows = n if batch_size is None or batch_size >= n else batch_size
        sl = self._rows(rows)
        return rows if sl is None else sl.stop - sl.start

    def train(self, train_data_fn: Callable,
              val_data_fn: Optional[Callable] = None, n_epochs: int = 100,
              batch_size: Optional[int] = None, shuffle: bool = True,
              print_every: int = 10, save_path: Optional[str] = None,
              resume_from_checkpoint: bool = True,
              config: Optional[Dict] = None, chunk_epochs="auto") -> Dict:
        """The epoch loop (reference utils/training.py:126-287).  Under a
        mesh every rank runs it, rank 0 alone printing, and checkpoints are
        collective (:func:`..checkpoint.save_checkpoint`).

        ``chunk_epochs`` (``njode_tpu/utils/training.py:887-944``): where
        the training data come from a :class:`DataLoader` and the
        validation data from one too or not at all, the epochs run in
        chunks (:meth:`_train_chunked`): ``"auto"`` chunks of
        ``print_every`` epochs, an int chunks of that many, 0, False or
        None the per-epoch loop.  Other data callables take the per-epoch
        loop."""
        say = self._say
        start_epoch = 0
        if resume_from_checkpoint and checkpoint_exists(save_path):
            say(f"Found existing checkpoint at {save_path}")
            try:
                self.load_model(save_path)
                start_epoch = len(self.train_losses)
                best = min(self.train_losses) if self.train_losses else float("nan")
                say(f"Resuming from epoch {start_epoch} "
                    f"(previous best loss: {best:.6f})")
                if start_epoch >= n_epochs:
                    say(f"Training already completed ({start_epoch} >= "
                        f"{n_epochs} epochs)")
                    return {"train_loss": self.train_losses,
                            "val_loss": self.val_losses,
                            "epoch_times": self.epoch_times,
                            "relative_loss": self.relative_losses,
                            "resumed_from_checkpoint": True}
            except Exception as e:  # fresh training, like the reference
                say(f"Warning: Could not load checkpoint ({e}). "
                    f"Starting fresh training.")
                start_epoch = 0
                self.train_losses, self.val_losses = [], []
                self.epoch_times, self.relative_losses = [], []

        history = {"train_loss": self.train_losses.copy(),
                   "val_loss": self.val_losses.copy(),
                   "epoch_times": self.epoch_times.copy(),
                   "relative_loss": self.relative_losses.copy()}
        rel = None
        if config and "data" in config and "process_type" in config["data"]:
            rel = self._setup_relative_loss(train_data_fn, config)

        use_chunks = (chunk_epochs not in (0, False, None)
                      and isinstance(train_data_fn, DataLoader)
                      and (val_data_fn is None
                           or isinstance(val_data_fn, DataLoader)))
        if use_chunks:
            return self._train_chunked(
                train_data_fn, val_data_fn, start_epoch, n_epochs,
                batch_size, shuffle, print_every, save_path, rel, history,
                print_every if chunk_epochs == "auto" else int(chunk_epochs))

        # resolved on the first batch, and again on any later batch with
        # padded slots while the kernel is in use: True then raises, "auto"
        # goes on composed
        use_kernel = None
        val_batch = None
        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            times, values, mask, _ = as_dense(
                _call_data_fn(train_data_fn, epoch), self.device)
            if use_kernel is None or (use_kernel and not bool(mask.all())):
                decline = self._kernel_decline(batch_size, times.shape[1],
                                               mask)
                self._say_route(decline, times.shape, batch_size, epoch,
                                report=use_kernel is None)
                use_kernel = decline is None
            if use_kernel:
                loss = self._kernel_epoch(times, values, epoch, batch_size,
                                          shuffle)
            else:
                loss = self._epoch_update(times, values, mask, epoch,
                                          batch_size, shuffle)
            train_loss = float(loss)
            self.train_losses.append(train_loss)
            history["train_loss"].append(train_loss)

            val_loss = None
            if val_data_fn is not None:
                if val_batch is None or not (isinstance(val_data_fn,
                                                        DataLoader)
                                             and val_data_fn.cache):
                    val_batch = as_dense(_call_data_fn(val_data_fn, epoch),
                                         self.device)
                vt, vv, vm, _ = val_batch
                val_loss = self.validate(vt, vv, mask=vm)
                self.val_losses.append(val_loss)
                history["val_loss"].append(val_loss)

            if rel is not None and epoch % print_every == 0:
                r = self.compute_relative_loss(rel)
                history["relative_loss"].append(r)
                self.relative_losses.append(r)

            epoch_time = time.time() - t0
            history["epoch_times"].append(epoch_time)
            self.epoch_times.append(epoch_time)

            if epoch % print_every == 0 or epoch == start_epoch:
                msg = f"Epoch {epoch:4d} | Train Loss: {train_loss:.6f}"
                if val_loss is not None:
                    msg += f" | Val Loss: {val_loss:.6f}"
                if history["relative_loss"]:
                    msg += f" | Rel Loss: {history['relative_loss'][-1]:.4f}"
                msg += f" | Time: {epoch_time:.2f}s"
                if start_epoch > 0 and epoch == start_epoch:
                    msg += " (resumed)"
                say(msg, flush=True)
                if save_path is not None:
                    self.save_model(save_path)

        if save_path is not None:
            self.save_model(save_path)
        return history

    def _say_route(self, decline: Optional[str], shape, batch_size,
                   epoch: int, report: bool, chunked: str = "") -> None:
        """The "Training path:" line of a batch of ``shape`` (B, N) from
        ``epoch`` (``decline`` as :meth:`_kernel_decline` gave it; the
        chunked route's mode appended), and with ``report`` the kernel
        report (``njode_tpu/utils/training.py:566-601``), once a train()
        call."""
        kernel = ("walk-train kernel" if self._twin() == "walk"
                  else "whole-run kernel")
        if self._mxu_dtype() != "float32":
            kernel += f" ({self._mxu_dtype()} products)"
        rows = self._step_rows(shape[0], batch_size)
        m = self.model
        forced = m._forced_route()
        comp = ("composed (fused-step kernels)"
                if m._use_fused_step(shape[1], rows)
                else f"composed (forced {forced})" if forced
                else f"composed (per-gap {m.ode_solver} loop)"
                if m.dt_ode_step is not None and not m._walks()
                else "composed")
        if self.mesh is not None and self.mesh.n_model > 1:
            if self.mesh.n_data > 1:
                comp += f", data-parallel over {self.mesh.n_data} ranks"
            comp += (f", model axis of {self.mesh.n_model} ranks "
                     f"({self._model_axis_text()}) ({self.mesh.backend})")
        elif self.mesh is not None:
            comp += (f", data-parallel over {self.mesh.n_data} ranks "
                     f"({self.mesh.backend})")
        self._say(f"Training path: {comp if decline else kernel} from epoch "
                  f"{epoch} (use_train_kernel={self.use_train_kernel!r}, "
                  f"device {self.device}){chunked}", flush=True)
        if report:
            from ..ops.report import kernel_report
            self._say(kernel_report(
                m, n_rows=rows, n_slots=shape[1],
                train_kernel=decline or "on" + (
                    " (walk twin)" if self._twin() == "walk" else ""),
                model_axis=(self._model_axis_text()
                            if self.shard is not None else None)),
                flush=True)

    # ------------------------------------------------------ chunked route

    def _graph_decline(self, use_kernel: bool, loader: "DataLoader"
                       ) -> Optional[str]:
        """None where the chunked route is captured as CUDA graphs on the
        card: every single-device route, the whole-run kernels (rows 11-12,
        13 with row 1 in validation) and the composed ones (the fused step,
        rows 9-10; the per-gap euler, heun and rk4 loops; the forced
        gap-loop pair, rows 2-5; the grid walk, rows 7-8 under autograd;
        the forced fused Euler cell, row 6; plain), their host-reading
        guards noted on the device (:class:`DeferredGuards`), on the data of
        every family, registered processes too (their draws checked for
        host reads: :func:`_draw`); else why its chunks run eagerly."""
        if self.mesh is not None:
            return ("a mesh: every step's collectives run through the "
                    "process group")
        if not same_device(loader.device, self.device):
            return "the loader's device is not the model's"
        if self.model.debug_checks:
            return "debug_checks reads the host"
        if use_kernel:
            return None
        if self.device.type == "cuda" and not all(
                g.get("capturable", False)
                for g in self.optimizer.param_groups):
            return ("the optimizer is not capturable (make_adam builds "
                    "torch.optim.Adam with capturable=True on the card)")
        return None

    def _train_chunked(self, loader: "DataLoader", val_loader, start_epoch,
                       n_epochs, batch_size, shuffle, print_every, save_path,
                       rel, history, chunk_len) -> Dict:
        """The chunked route (``njode_tpu/utils/training.py:1045-1134``):
        the epochs in chunks that end on print boundaries, also after an
        unaligned resume; each epoch draws its data (the training loader's
        seeds, or its cached batch), trains, and takes the validation loss
        of the validation loader's first batch, and at print epochs the
        relative loss.  The losses reach the host once a chunk, the
        non-finite warning names the epoch, and a checkpoint is written at
        every chunk end and at the end.  On the card a capturable route
        (:meth:`_graph_decline`) replays each epoch as a CUDA graph
        (:class:`_ChunkRun`); elsewhere the chunk runs the same program
        eagerly."""
        first = as_dense(loader(start_epoch), self.device)
        decline = self._kernel_decline(batch_size, first[0].shape[1],
                                       first[2])
        use_kernel = decline is None
        eager = self._graph_decline(use_kernel, loader)
        capture = eager is None and self.device.type == "cuda"
        mode = ("CUDA graph" if capture
                else f"eager: {eager or 'not on a CUDA device'}")
        self._say_route(decline, first[0].shape, batch_size, start_epoch,
                        report=True, chunked=f", chunked ({mode})")
        run = _ChunkRun(self, loader, val_loader, rel, batch_size, shuffle,
                        use_kernel, capture, eager is None,
                        first[0].shape[1], n_epochs)
        self._chunk_run = run
        try:
            self._run_chunks(run, start_epoch, n_epochs, print_every,
                             save_path, history, chunk_len)
        finally:
            run.release()
            # replays move the weights without bumping their versions
            self.model._drop_gap_cache()
        if save_path is not None:
            self.save_model(save_path)
        return history

    def _run_chunks(self, run: "_ChunkRun", start_epoch: int, n_epochs: int,
                    print_every: int, save_path, history: Dict,
                    chunk_len: int) -> None:
        """The chunk loop of :meth:`_train_chunked`."""
        say = self._say
        epoch = start_epoch
        while epoch < n_epochs:
            # chunk ends on print boundaries keep the print and checkpoint
            # cadence after an unaligned resume
            L = min(chunk_len, print_every - epoch % print_every,
                    n_epochs - epoch)
            t0 = time.time()
            tr, vl, rl = run.chunk(epoch, L, print_every)
            per_epoch = (time.time() - t0) / L
            if not all(math.isfinite(x) for x in tr):
                bad = next(i for i, x in enumerate(tr)
                           if not math.isfinite(x))
                say(f"Warning: non-finite training loss at epoch "
                    f"{epoch + bad} — try a lower learning rate or "
                    f"variance_method='second_moment'.", flush=True)
            for i in range(L):
                self.train_losses.append(tr[i])
                history["train_loss"].append(tr[i])
                if run.val is not None:
                    self.val_losses.append(vl[i])
                    history["val_loss"].append(vl[i])
                if run.rel is not None and (epoch + i) % print_every == 0:
                    self.relative_losses.append(rl[i])
                    history["relative_loss"].append(rl[i])
                history["epoch_times"].append(per_epoch)
                self.epoch_times.append(per_epoch)
            for i in range(L):
                e = epoch + i
                if e % print_every == 0 or e == start_epoch:
                    msg = f"Epoch {e:4d} | Train Loss: {tr[i]:.6f}"
                    if run.val is not None:
                        msg += f" | Val Loss: {vl[i]:.6f}"
                    if history["relative_loss"]:
                        msg += (f" | Rel Loss: "
                                f"{history['relative_loss'][-1]:.4f}")
                    msg += f" | Time: {per_epoch:.2f}s"
                    if start_epoch > 0 and e == start_epoch:
                        msg += " (resumed)"
                    say(msg, flush=True)
            if save_path is not None:
                self.save_model(save_path)
            epoch += L

    # ------------------------------------------------------------- persist

    def _histories(self):
        return {"train_losses": self.train_losses,
                "val_losses": self.val_losses,
                "epoch_times": self.epoch_times,
                "relative_loss": self.relative_losses}

    def _model_axis_text(self) -> str:
        return self.shard.describe() if self.shard is not None else "none"

    def save_model(self, path: str):
        """Write a checkpoint (collective under a mesh: every rank calls
        it; ``checkpoint_backend`` "msgpack" is one file from rank 0,
        "orbax" a ``torch.distributed.checkpoint`` directory).  Under the
        model axis the file holds the one-process layout, gathered from
        the ranks' parts; the directory takes each rank's own part."""
        if self.shard is not None and self.checkpoint_backend == "orbax":
            sd, osd = self.shard.pieces(self.optimizer)
        else:
            sd, osd = self.full_state()
        save_checkpoint(path, sd, osd, self._histories(),
                        backend=self.checkpoint_backend)

    def full_state(self) -> tuple[dict, dict]:
        """(model state dict, optimizer state dict) in the one-process
        layout: gathered under the model axis (collective: every rank of
        the model group calls it)."""
        if self.shard is None:
            return self.model.state_dict(), self.optimizer.state_dict()
        return (self.shard.model_state(),
                self.shard.optimizer_state(self.optimizer))

    def load_model(self, path: str):
        """Load a checkpoint of the one-process layout (either backend,
        written by any mesh): under the model axis this rank takes its
        part."""
        sd, osd, hist = load_checkpoint(path, map_location=self.device)
        if self.shard is not None:
            self.shard.load(sd, osd, self.optimizer)
        else:
            self.model.load_state_dict(sd)
            load_optimizer_state(self.optimizer, osd)
        self.train_losses = hist["train_losses"]
        self.val_losses = hist["val_losses"]
        self.epoch_times = hist["epoch_times"]
        self.relative_losses = hist["relative_loss"]


def same_device(a, b) -> bool:
    """Whether two devices are one: ``cuda`` without an index is the
    current card (a loader made with the default device names it so, the
    model's parameters by its index)."""
    def full(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return full(a) == full(b)


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state: dict) -> None:
    """``optimizer.load_state_dict(state)`` keeping the optimizer's own
    ``capturable`` flags: a state saved off the card resumes on it with its
    step count on the card (torch.optim puts it there for a capturable
    group), and one saved on the card resumes on the CPU with it on the
    host."""
    groups = [{**g, "capturable": own.get("capturable", False)}
              if "capturable" in g or "capturable" in own else g
              for g, own in zip(state["param_groups"],
                                optimizer.param_groups)]
    optimizer.load_state_dict({**state, "param_groups": groups})


def _rebuilt(optimizer: torch.optim.Optimizer, params: list
             ) -> torch.optim.Optimizer:
    """An optimizer of ``optimizer``'s type and one param group's
    hyperparameters over ``params`` (a rank's part of the model)."""
    if len(optimizer.param_groups) != 1:
        raise ValueError("the model axis takes an optimizer with one param "
                         "group")
    group = {k: v for k, v in optimizer.param_groups[0].items()
             if k != "params"}
    return type(optimizer)(params, **group)


# --------------------------------------------------------------------------
# the chunked route's programs
# --------------------------------------------------------------------------

class _Streams:
    """The chunked route's generators, one a stream an epoch draws from (the
    training data, the shuffle, dropout: one, or one a separate network),
    kept for the whole run and reseeded before every epoch with the seeds
    the per-epoch loop gives its fresh generators, so both draw the same."""

    def __init__(self, trainer: "Trainer", loader: "DataLoader",
                 batch_size: Optional[int], shuffle: bool, kernel: bool,
                 draws: bool = True):
        n, dev = loader.n_trajectories, trainer.device
        self.trainer, self.loader = trainer, loader
        full = not kernel and (batch_size is None or batch_size >= n)
        self.sharded = trainer._rows(n if full else batch_size) is not None
        # ``draws`` False: another stream draws this loader's batch
        self.data = (None if loader.cache or not draws
                     else torch.Generator(device=loader.device))
        self.shuffle = (torch.Generator(device=dev) if shuffle and not full
                        else None)
        seeds = None if kernel else trainer._dropout_seeds(0, self.sharded)
        self.dropout = (None if seeds is None
                        else torch.Generator(device=dev)
                        if isinstance(seeds, int)
                        else [torch.Generator(device=dev) for _ in seeds])

    def generators(self) -> list:
        drop = (self.dropout if isinstance(self.dropout, list)
                else [self.dropout])
        return [g for g in (self.data, self.shuffle, *drop) if g is not None]

    def seed(self, epoch: int) -> None:
        """Seed every stream for ``epoch`` (host only)."""
        t = self.trainer
        if self.data is not None:
            self.data.manual_seed(self.loader.seed_of(epoch))
        if self.shuffle is not None:
            self.shuffle.manual_seed(stream_seed(t.seed, STREAM_SHUFFLE,
                                                 epoch))
        seeds = t._dropout_seeds(epoch, self.sharded)
        if isinstance(self.dropout, list):
            for g, s in zip(self.dropout, seeds):
                g.manual_seed(s)
        elif self.dropout is not None:
            self.dropout.manual_seed(seeds)


def _draw(loader: "DataLoader", generator: torch.Generator, captured: bool,
          eager: str) -> tuple:
    """A fresh batch of ``loader`` from ``generator``: (times, values,
    mask).  On a route whose epochs a CUDA graph captures (``captured``),
    a registered process's draw runs under ``set_sync_debug_mode("error")``
    (the warm-up is the first such call): a generator that reads the host,
    where a graph would replay what it read once, raises, naming the
    process and the eager route (``eager``).  As JAX's trace of such a generator fails, it
    neither falls back to eager chunks nor yields the captured data."""
    from ..simulation.registry import get_obs_values_fn, get_paths_fn
    pt = loader.process_type
    if not captured or (get_paths_fn(pt) is None
                        and get_obs_values_fn(pt) is None):
        b = loader.generate(generator)
        return b.times, b.values, b.mask
    from .chunked import sync_debug_mode
    try:
        with sync_debug_mode("error"):
            b = loader.generate(generator)
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        raise RuntimeError(
            f"the registered process {pt!r} reads the host "
            f"while it draws ({e}); the chunked route captures each "
            f"epoch's draw in a CUDA graph, which would replay what it "
            f"read once: draw on the device from the generator alone, or "
            f"train eagerly ({eager})") from e
    return b.times, b.values, b.mask


class _ChunkRun:
    """The chunked route's programs for one ``train()`` call: the epoch
    (data, shuffle, packing, the whole-run kernel or the composed steps,
    the validation loss) and the relative loss of a print epoch, each an
    :class:`~.chunked.EpochProgram`, captured as a CUDA graph with
    ``capture``.  The whole-run kernels keep their state (parameters, Adam
    moments, powers) in buffers of their own through a chunk: the
    optimizer's state goes in at the chunk's start and back, L x nb steps
    on, at its end (``njode_tpu/utils/training.py:653``, ``:714``); each
    epoch sets the powers from the step count on the device, as the
    per-epoch route's conversion does, and writes the parameters into the
    model for its validation.  ``defer``: the model's host-reading guards
    and the whole-run kernels' padded-mask gate note on the device and
    raise after the chunk (:class:`~..models.jump_ode.DeferredGuards`).
    ``n_epochs``: the run's end, past which no epoch calls a program again
    (a program first called there is not captured; None: no end)."""

    def __init__(self, trainer: "Trainer", loader: "DataLoader", val_loader,
                 rel, batch_size: Optional[int], shuffle: bool, kernel: bool,
                 capture: bool, defer: bool, n_slots: int,
                 n_epochs: Optional[int] = None):
        from .chunked import EpochProgram
        dev = trainer.device
        self.t, self.loader, self.rel = trainer, loader, rel
        self.n_epochs = math.inf if n_epochs is None else n_epochs
        self.batch_size, self.shuffle = batch_size, shuffle
        self.kernel = kernel
        self.guards = DeferredGuards() if defer else None
        n = loader.n_trajectories
        self.bs = batch_size if batch_size is not None else n
        self.nb = -(-n // self.bs)
        self.streams = _Streams(trainer, loader, batch_size, shuffle, kernel)
        self.cached = (as_dense(loader(0), dev)[:3] if loader.cache
                       else None)
        self.val = (as_dense(val_loader(0), dev)[:3]
                    if val_loader is not None else None)
        if rel is not None:
            with torch.no_grad():
                self.l_true = nj_ode_loss_dense(
                    rel["values"], rel["y_true"], rel["y_true_before"],
                    rel["mask"], moment_weights=trainer.moment_weights,
                    variance_method=trainer.variance_method,
                    extended_moments=trainer.extended_moments).double()
        if kernel:
            self.kw = trainer._kernel_kw(n_slots, self.bs)
            self.state = None
        self.epoch = EpochProgram(
            self._twin_body if kernel else self._composed_body, capture,
            self.streams.generators(), "epoch", dev)
        self.relative = (EpochProgram(self._rel_body, capture, (),
                                      "relative loss", dev)
                         if rel is not None else None)

    def release(self) -> None:
        """Free the programs' graphs (after the run)."""
        for prog in (self.epoch, self.relative):
            if prog is not None:
                prog.release()

    # ------------------------------------------------------------ a chunk

    def chunk(self, epoch: int, L: int, print_every: int) -> tuple:
        """Epochs epoch..epoch+L-1: (train, validation, relative) losses,
        lists of L floats (NaN where not taken), read at the end in one
        transfer.  A program is captured only where a later epoch of the
        run (before ``n_epochs``) calls it again."""
        t = self.t
        self.begin()
        buf = torch.full((3, L), math.nan, dtype=torch.float64,
                         device=t.device)
        checked = t.check_syncs and t.device.type == "cuda"
        from .chunked import sync_debug_mode
        with sync_debug_mode("error") if checked else contextlib.nullcontext():
            for i in range(L):
                e = epoch + i
                self.streams.seed(e)
                tr, vl = self.epoch(again=e + 1 < self.n_epochs)
                buf[0, i].copy_(tr)
                if vl is not None:
                    buf[1, i].copy_(vl)
                if self.relative is not None and e % print_every == 0:
                    buf[2, i].copy_(self.relative(
                        again=e + print_every < self.n_epochs)[0])
        self.end(L)
        if self.guards is not None:
            self.guards.check()
        return tuple(buf.tolist())

    def begin(self) -> None:
        """A whole-run kernel's state from the model and the optimizer,
        into the buffers the epochs read (host: reads the step count)."""
        if not self.kernel:
            return
        from ..ops import train_kernel as tk
        from ..ops import walk_train as wt
        t, m = self.t, self.t.model
        self.opt_sd = t.optimizer.state_dict()
        state_from = (wt.walk_state_from if t._twin() == "walk"
                      else tk.kernel_state_from)
        state = state_from(m, self.opt_sd, betas=self.kw["betas"])
        per = self.opt_sd.get("state", {})
        step = float(next(iter(per.values()))["step"]) if per else 0.0
        if self.state is None:
            self.state = type(state)(*(x.clone() for x in state))
            self.betas = torch.tensor(self.kw["betas"], dtype=torch.float32,
                                      device=t.device)
            self.steps = torch.zeros((), dtype=torch.float32,
                                     device=t.device)
        else:
            for dst, src in zip(self.state, state):
                dst.copy_(src)
        self.steps.fill_(step)

    def end(self, L: int) -> None:
        """The whole-run kernel's state back into the model and the
        optimizer, L x nb steps on."""
        if not self.kernel:
            return
        from ..ops import train_kernel as tk
        from ..ops import walk_train as wt
        t, m = self.t, self.t.model
        state_into = (wt.optax_state_into_walk if t._twin() == "walk"
                      else tk.optax_state_into)
        sd, osd = state_into(self.state, L * self.nb, self.opt_sd, m)
        with torch.no_grad():
            m.load_state_dict(sd)
        t.optimizer.load_state_dict({
            "state": {i: {k: v.clone() for k, v in s.items()}
                      for i, s in osd["state"].items()},
            "param_groups": osd["param_groups"]})

    # ----------------------------------------------------- device bodies

    def _guarded(self):
        return (self.t.model.deferred_guards(self.guards)
                if self.guards is not None else contextlib.nullcontext())

    def _data(self) -> tuple:
        if self.cached is not None:
            return self.cached
        return _draw(self.loader, self.streams.data, self.epoch.capture,
                     "chunk_epochs=0 runs the per-epoch loop")

    def _val_loss(self) -> Optional[torch.Tensor]:
        if self.val is None:
            return None
        t = self.t
        t.model._drop_gap_cache()
        with torch.no_grad():
            return t._eval_loss(
                lambda tt, v, mk, tm: t._loss(tt, v, mk, traj_mask=tm),
                *self.val)

    def _full_mask(self, mask: torch.Tensor) -> None:
        """The whole-run kernels take every slot as an observation."""
        if self.guards is None:
            if not bool(mask.all()):
                self._padded(1.0)
            return
        self.guards.note("padded slots", (~mask).any().to(torch.float32),
                         self._padded)

    @staticmethod
    def _padded(any_padded: float) -> None:
        if any_padded:
            raise ValueError("train kernel not applicable: the batch has "
                             "padded slots (its mask is not all True); the "
                             "kernel takes every slot as an observation")

    def _composed_body(self) -> tuple:
        with self._guarded():
            times, values, mask = self._data()
            loss = self.t._epoch_update(times, values, mask, 0,
                                        self.batch_size, self.shuffle,
                                        self.streams)
            return loss, self._val_loss()

    def _twin_body(self) -> tuple:
        from ..ops import train_kernel as tk
        from ..ops import walk_train as wt
        t, m = self.t, self.t.model
        walk = t._twin() == "walk"
        with self._guarded(), torch.no_grad():
            times, values, mask = self._data()
            self._full_mask(mask)
            if walk:
                m._check_grid_alignment(times, None)
            idx, valid = t._minibatches(0, times.shape[0], self.bs,
                                        self.shuffle, self.streams.shuffle)
            ids = idx.reshape(-1)
            data = tk.pack_minibatches(times[ids], values[ids],
                                       valid.reshape(-1), self.bs)
            st = self.state
            # the powers from the step count, as the conversion makes them
            st.stat.copy_(torch.pow(self.betas, self.steps))
            run = wt.fused_walk_train_run if walk else tk.fused_train_run
            out, losses = run(st, data, **self.kw)
            for dst, src in zip(st, out):
                dst.copy_(src)
            self.steps.add_(self.nb)
            params = (wt.walk_train_params(st, m.hidden_dim, m.num_moments)
                      if walk else tk.train_state_params(st, m.hidden_dim))
            named = dict(m.named_parameters())
            for k, v in params.items():
                named[k].copy_(v)
            return losses.mean(), self._val_loss()

    def _rel_body(self) -> tuple:
        t, rel = self.t, self.rel
        t.model._drop_gap_cache()
        with self._guarded(), torch.no_grad():
            lm = t._eval_loss(
                lambda tt, v, mk, tm: t._loss_no_first(tt, v, mk),
                rel["times"], rel["values"], rel["mask"])
        # in float64, as the per-epoch route's host arithmetic
        return ((lm.double() - self.l_true)
                / torch.clamp_min(self.l_true, 1e-8),)


# --------------------------------------------------------------------------
# run_experiment
# --------------------------------------------------------------------------

def _refuse_unported(config: Dict) -> None:
    """The config options the port refuses: an unknown model axis mode or
    checkpoint backend (ValueError, the JAX package's messages), Pallas
    interpret mode (NotImplementedError)."""
    mode = config.get("model_parallel_mode")
    if mode not in (None, "none", "moments", "hidden"):
        raise ValueError(f"Unknown model_shard: {mode!r} "
                         "(one of 'none', 'moments', 'hidden')")
    if config.get("checkpoint_backend", "msgpack") not in ("msgpack",
                                                           "orbax"):
        raise ValueError(f"Unknown checkpoint backend: "
                         f"{config.get('checkpoint_backend')}")
    up = config.get("use_pallas", False)
    if up in ("interpret", "step-interpret"):
        raise NotImplementedError(
            f"use_pallas={up!r}: Pallas interpret mode is not ported; on "
            "the CPU True and 'step' run the kernels' plain versions")
    if up not in (False, None, "auto", "train", "step", True):
        raise ValueError(f"Unknown use_pallas: {up!r}")


def walk_cells(model) -> int:
    """M, the cells of the walk-train kernel's grid: round(t_max / dt), as
    the JAX Trainer counts them."""
    return int(round(model.t_max / model.dt_ode_step))


def _resolve_grid_walk(config: Dict, device: torch.device,
                       use_pallas_cfg=None, single_device: bool = True
                       ) -> bool:
    """The grid-walk policy (``njode_tpu/utils/training.py:1162-1219``):
    "on" walks, "off" keeps the per-gap loops, and "auto" walks exactly
    where a CUDA kernel carries the walk: the model on ``cuda``, kernels
    asked for (use_pallas "auto", "train" or True), the config eligible for
    the walk kernels (euler) or the walk-train kernel (heun, rk4), and the
    data aligned to the grid, on a single device (``single_device``: no
    mesh and no ensemble, ``njode_tpu/utils/training.py:1383``).  Off the
    card "auto" resolves off, as the JAX package does off the TPU."""
    setting = config.get("grid_walk", "auto")
    dt = config.get("dt_ode_step")
    if dt is None or setting in (False, "off", None):
        return False
    if setting in (True, "on"):
        return True
    if (device.type != "cuda" or not single_device
            or use_pallas_cfg not in ("auto", "train", True)):
        return False
    if (config.get("compute_dtype") not in (None, "float32", "none")
            or int(config.get("ensemble", 0) or 0) > 1
            or not _grid_walk_aligned(config)):
        return False
    from ..models.activations import (canonical_activation,
                                      canonical_input_scaling)
    from ..ops.walk_scan import walk_scan_available
    from ..ops.walk_train import walk_train_available
    act = canonical_activation(config.get("activation", "relu"))
    scale = canonical_input_scaling(config.get("input_scaling", "identity"))
    solver = config.get("ode_solver", "euler")
    if solver != "euler":
        # only the walk-train kernel carries a heun or rk4 walk
        return walk_train_available(
            bool(config.get("shared_network", False)), *_io_dims(config),
            int(config.get("n_hidden_layers", 1)), act,
            float(config.get("dropout_rate", 0.0)), scale, dt, solver)
    return walk_scan_available(
        int(config.get("n_hidden_layers", 1)), act,
        float(config.get("dropout_rate", 0.0)), scale,
        _io_dims(config)[0], int(config["hidden_dim"]))


def _io_dims(config: Dict) -> tuple[int, int]:
    """(input_dim, output_dim) of the config; a d-dimensional family's
    ``dims`` gives the widths a config leaves out."""
    dims = int(config.get("data", {}).get("dims", 1))
    d_x = int(config.get("input_dim", dims))
    return d_x, int(config.get("output_dim", d_x))


def _grid_walk_aligned(config: Dict) -> bool:
    """Whether the data config guarantees every observation time on the
    grid: the simulation spacing T/n_steps is a whole multiple of
    ``dt_ode_step`` (``njode_tpu/utils/training.py:1222``)."""
    dt = config.get("dt_ode_step")
    if dt is None:
        return False
    data = config.get("data", {})
    r = float(data.get("T", 1.0)) / int(data.get("n_steps", 100)) / float(dt)
    return round(r) >= 1 and abs(r - round(r)) < 1e-9


def _use_grid_walk(config: Dict, device: torch.device,
                   use_pallas_cfg=None, single_device: bool = True) -> bool:
    """Resolve the grid walk and refuse a misaligned "on" from the static
    config (``njode_tpu/utils/training.py:1235-1255``)."""
    if not _resolve_grid_walk(config, device, use_pallas_cfg, single_device):
        return False
    if not _grid_walk_aligned(config):
        data = config.get("data", {})
        spacing = float(data.get("T", 1.0)) / int(data.get("n_steps", 100))
        raise ValueError(
            f"grid_walk on: observation times are multiples of the "
            f"simulation grid spacing T/n_steps = {spacing:g}, which is not "
            f"an integer multiple of dt_ode_step = "
            f"{config.get('dt_ode_step')}; the walk would integrate on a "
            "grid the observations do not sit on. Choose a dt_ode_step that "
            "divides the grid spacing, or turn grid_walk off.")
    return True


def _rank_devices(config: Dict, n: int) -> Optional[list]:
    """Each rank's device from the config's "device": "cpu" puts every
    rank on the CPU and "cuda:K" every rank on card K (ranks that share a
    device talk over gloo); "auto" or "cuda" gives rank r a card of its own
    (None: the launcher's default, NCCL)."""
    dev = config.get("device", "auto")
    if dev in (None, "auto", "cuda"):
        return None
    return [str(torch.device(dev))] * n


def run_experiment(config: Dict, save_dir: str = "runs") -> Dict:
    """A whole training experiment (reference utils/training.py:349-438):
    ``runs/<experiment_name>/{config.json, model.ckpt, history.json}``.

    Scale-out (``njode_tpu/utils/training.py:1275-1333``, ``:1392-1409``):
    ``multihost`` joins the process group first
    (:func:`..parallel.initialize_distributed`).  Inside a group of several
    ranks (torchrun, ``multihost``, or spawned here) the run is this rank's
    share of a run over a D x M mesh of every rank (M = ``model_parallel``,
    D the rest); rank 0 writes the files and prints.  Without a group,
    ``data_parallel`` D > 1 or ``model_parallel`` M > 1 spawns D x M ranks
    (:func:`..parallel.launch`, the config's "device" placing them:
    :func:`_rank_devices`; D defaults to the cards M leaves, JAX's
    ``make_mesh(data=None)``, or 1 where every rank shares one device) and
    returns rank 0's result.  ``model_parallel_mode`` is "moments" (the
    default where M > 1) or "hidden".  An ensemble beside a device request
    spreads its members over a 1 x N mesh's model axis (JAX's
    ``make_mesh(data=1, model=n_dev)``)."""
    from ..parallel.mesh import world
    if (config.get("extended_moments", False)
            and config.get("data", {}).get("process_type") == "heston"):
        # the refusal moments_at_obs raises, before any work
        # (njode_tpu/utils/training.py:1264-1273)
        raise ValueError(
            "--extended-moments is unsupported for the heston process: "
            "higher conditional moments of the Heston price have no closed "
            "form (the BS approximation used for mean/variance does not "
            "extend).  Drop --extended-moments or use black_scholes / "
            "ornstein_uhlenbeck / hybrid_ou_bs.")
    # a population implies its member count: a config-dict caller never
    # silently trains one model (njode_tpu/utils/training.py:1302-1309);
    # config.json keeps the config as given, as there
    given = config
    n_ensemble = int(config.get("ensemble", 0) or 0)
    lrs_cfg = config.get("ensemble_lrs") or None
    if lrs_cfg and n_ensemble <= 1:
        n_ensemble = len(lrs_cfg)
        config = {**config, "ensemble": n_ensemble}
    _refuse_unported(config)
    up = config.get("use_pallas", False)
    if up == "train" and n_ensemble > 1:
        # njode_tpu/utils/training.py:1349-1354
        raise ValueError(
            "--kernels train is a single-model strategy; ensembles run "
            "the (measured-faster) XLA vmapped path — drop one flag")
    multihost = bool(config.get("multihost", False))
    if multihost:
        from ..parallel import initialize_distributed
        initialize_distributed(
            coordinator_address=config.get("coordinator_address"),
            num_processes=config.get("num_processes"),
            process_id=config.get("process_id"))
    rank, size = world()
    n_dp = int(config.get("data_parallel", 0) or 0)
    n_dev = size if multihost else n_dp
    if n_ensemble > 1 and n_dev > 1 and n_ensemble % n_dev:
        # njode_tpu/utils/training.py:1318-1325
        raise ValueError(
            f"--ensemble {n_ensemble} cannot shard over {n_dev} "
            f"devices: the member count must be a multiple of the "
            f"device count (ensemble runs parallelize over the seed "
            f"axis). Use --ensemble {n_dev * max(1, n_ensemble // n_dev)} "
            f"or adjust --data-parallel.")
    n_mp = 1 if n_ensemble > 1 else _model_parallel(config)
    if size == 1:
        n = n_dp if n_ensemble > 1 else _spawn_shape(config, n_dp, n_mp)
        if n > 1:
            from ..parallel import launch
            return launch(run_experiment, n, args=(given, save_dir),
                          devices=_rank_devices(config, n))[0]
    elif n_dp > 1 and n_dp * n_mp != size:
        raise ValueError(f"--data-parallel {n_dp}"
                         + (f" --model-parallel {n_mp}" if n_mp > 1 else "")
                         + f" in a world of {size} ranks: one rank a device")
    with contextlib.redirect_stdout(
            io.StringIO()) if rank else contextlib.nullcontext():
        return _run_experiment(given, config, save_dir, n_ensemble, up)


def _model_parallel(config: Dict) -> int:
    return int(config.get("model_parallel", 1) or 1)


def _spawn_shape(config: Dict, n_dp: int, n_mp: int) -> int:
    """The ranks a run without a group spawns: D x M, D from
    ``data_parallel`` or, under a model axis, JAX's ``make_mesh(data=None)``
    rule over the cards (max(1, cards // M)); 1 where every rank would
    share one device ("cpu", "cuda:K").  Raises JAX's "mesh DxM needs N
    devices, have C" where rank r would take card r and there are too few
    cards."""
    if n_dp <= 1 and n_mp <= 1:
        return 1
    shared = _rank_devices(config, 1) is not None
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n_data = (n_dp if n_dp > 1 else 1 if shared
              else max(1, cards // n_mp))
    n = n_data * n_mp
    if not shared and n > cards:
        raise ValueError(f"mesh {n_data}x{n_mp} needs {n} devices, "
                         f"have {cards}")
    return n


def _run_experiment(given: Dict, config: Dict, save_dir: str,
                    n_ensemble: int, up) -> Dict:
    """``run_experiment`` on this process: one model on one device, or this
    rank's share of a run over every rank of the group."""
    from ..parallel import global_mesh, is_primary, make_mesh
    from ..parallel.mesh import world
    from ..parallel.model_axis import model_axis_note
    rank, size = world()
    mesh = None
    n_mp = _model_parallel(config)
    mode = config.get("model_parallel_mode") or ("moments" if n_mp > 1
                                                 else "none")
    if size > 1:
        devices = _rank_devices(config, size)
        if n_ensemble > 1:
            # the members over the model axis (njode_tpu/utils/
            # training.py:1317-1326)
            mesh = make_mesh(data=1, model=size, devices=devices)
            note = "the ensemble's members over the model axis"
        else:
            # every rank on the device its launcher set: the mesh over all
            # processes (njode_tpu/utils/training.py:1327-1329)
            mesh = (global_mesh(model=n_mp) if devices is None
                    else make_mesh(data=size // n_mp, model=n_mp,
                                   devices=devices))
            note = (model_axis_note(mode, bool(config.get("shared_network",
                                                          False)),
                                    int(config.get("num_moments", 1)), n_mp)
                    if n_mp > 1 and mode != "none" else "")
        print(f"Distributed: {size} ranks (data axis {mesh.n_data}, model "
              f"axis {mesh.n_model}), backend {mesh.backend}, rank 0 on "
              f"{mesh.device}" + (f"; {note}" if note else ""), flush=True)
        device = mesh.device
    else:
        # config "device": "auto" or absent means cuda (raising without
        # one), "cpu" the CPU, any other torch device string as given
        device = resolve_device(config.get("device", "auto"))
    save_path = Path(save_dir) / config["experiment_name"]
    if is_primary():
        save_path.mkdir(parents=True, exist_ok=True)
        with open(save_path / "config.json", "w") as f:
            json.dump(given, f, indent=2)
    print(f"Device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    # use_pallas 'auto' (the CLI default) and 'train' select the whole-run
    # training kernel of the model's twin, quietly and insistently
    # (njode_tpu/utils/training.py:1338-1348), for one model only: an
    # ensemble engages none (:1340); the model keeps 'auto' for its own
    # kernels (the gap kernel, the walk kernels), and 'step' and True go to
    # the model (its fused-step kernels, its forced per-gap kernels) with
    # the whole-run kernels off
    use_train_kernel = {"auto": "auto", "train": True}.get(up, False)
    input_dim, output_dim = _io_dims(config)
    model = NeuralJumpODE(
        input_dim=input_dim, hidden_dim=config["hidden_dim"],
        output_dim=output_dim,
        dt_between_obs=config.get("dt_between_obs"),
        dt_ode_step=config.get("dt_ode_step"),
        num_moments=config.get("num_moments", 1),
        n_hidden_layers=config.get("n_hidden_layers", 1),
        activation=config.get("activation", "relu"),
        shared_network=config.get("shared_network", False),
        dropout_rate=config.get("dropout_rate", 0.0),
        input_scaling=config.get("input_scaling", "identity"),
        variance_method=config.get("variance_method", "direct"),
        t_max=config.get("data", {}).get("T", 1.0),
        compute_dtype=config.get("compute_dtype"),
        ode_solver=config.get("ode_solver", "euler"),
        use_pallas=up if up in ("auto", "step", True) else False,
        debug_checks=config.get("debug_checks", False),
        # grid-walk resolution sees the config's use_pallas: "train" with
        # dt_ode_step routes to the walk-train kernel, which needs the same
        # grid promise (njode_tpu/utils/training.py:1381-1384); "auto"
        # keeps an ensemble off the walk, "on" walks it
        grid_walk=_use_grid_walk(
            config, device, up,
            single_device=(mesh is None and n_ensemble <= 1)),
        device=device,
        generator=torch.Generator().manual_seed(int(config.get("seed", 0))))
    if n_ensemble > 1:
        return _run_ensemble_experiment(config, model, save_path, n_ensemble,
                                        mesh=mesh)
    optimizer = make_adam(model.parameters(), config["learning_rate"],
                          config["weight_decay"])
    trainer = Trainer(
        model, optimizer,
        ignore_first_continuity=config.get("ignore_first_continuity", False),
        moment_weights=config.get("moment_weights"),
        variance_method=config.get("variance_method", "direct"),
        extended_moments=config.get("extended_moments", False),
        mesh=mesh, seed=config.get("seed", 0),
        checkpoint_backend=config.get("checkpoint_backend", "msgpack"),
        use_train_kernel=use_train_kernel,
        train_kernel_opts={"mxu_dtype": config.get("train_kernel_mxu",
                                                   "float32")},
        model_shard=mode)
    train_data_fn, val_data_fn = create_data_loaders(
        base_seed=config.get("data_seed", 0), device=device,
        **config["data"])

    print(f"Starting experiment: {config['experiment_name']}")
    print(f"Model parameters: {model.n_params():,}")
    history = trainer.train(
        train_data_fn=train_data_fn, val_data_fn=val_data_fn,
        n_epochs=config["n_epochs"], batch_size=config.get("batch_size"),
        shuffle=config.get("shuffle", True),
        print_every=config.get("print_every", 10),
        save_path=str(save_path / "model.ckpt"),
        resume_from_checkpoint=config.get("resume_from_checkpoint", True),
        config=config)
    if is_primary():
        with open(save_path / "history.json", "w") as f:
            json.dump(history, f, indent=2)
    print(f"Experiment completed. Results saved to {save_path}")
    return {"config": config, "history": history,
            "save_path": str(save_path),
            "final_train_loss": history["train_loss"][-1],
            "final_val_loss": (history["val_loss"][-1]
                               if history["val_loss"] else None)}


# --------------------------------------------------------------------------
# run_experiment's ensemble route
# --------------------------------------------------------------------------

def _rel_l_true(config: Dict, model, times, values, mask,
                switch_times=None) -> torch.Tensor:
    """Each member's true-predictor loss on its relative-loss batch:
    (K, n, N) times, values and mask (and (K, n) switch times) -> (K,)."""
    data = config["data"]
    process_type = data["process_type"]
    params = {k: v for k, v in data.items() if k != "process_type"}
    out = []
    for s in range(times.shape[0]):
        y_true, y_true_before = moments_at_obs(
            times[s], values[s], process_type,
            num_moments=model.num_moments,
            variance_method=config.get("variance_method", "direct"),
            mask=mask[s],
            switch_times=None if switch_times is None else switch_times[s],
            **params)
        out.append(nj_ode_loss_dense(
            values[s], y_true, y_true_before, mask[s],
            moment_weights=config.get("moment_weights"),
            variance_method=config.get("variance_method", "direct"),
            extended_moments=config.get("extended_moments", False)))
    return torch.stack(out)


def _ensemble_rel_eval(config: Dict, model, n_seeds: int,
                       share_data: bool = False) -> Optional[Dict]:
    """Each member's relative-loss data: the first 10 trajectories of its
    epoch-0 training stream and their true-predictor loss, the single
    model's ``_setup_relative_loss`` a member
    (``njode_tpu/utils/training.py:1449-1501``); ``share_data`` gives every
    member the same batch, as its training data.  None for a process with
    no truths."""
    from .ensemble import _member_seeds
    data = dict(config["data"])
    process_type = data["process_type"]
    from ..simulation.registry import get_moments_fn
    if (process_type not in RELATIVE_LOSS_PROCESSES
            and get_moments_fn(process_type) is None):
        return None
    proc_kwargs = {k: v for k, v in data.items()
                   if k not in ("process_type", "n_train", "n_val",
                                "obs_fraction", "cache_data", "obs_only")}
    batches = []
    for ds in _member_seeds(config.get("data_seed", 0), n_seeds, share_data):
        b = DataLoader(ds, data["n_train"], process_type,
                       data.get("obs_fraction", 0.1), False, proc_kwargs,
                       obs_only=bool(data.get("obs_only", False)),
                       stream=STREAM_TRAIN, device=model.device)(0)
        batches.append(b)
    times = torch.stack([b.times[:10] for b in batches])
    values = torch.stack([b.values[:10] for b in batches])
    mask = torch.stack([b.mask[:10] for b in batches])
    switch_times = None
    if (process_type == "hybrid_ou_bs" and data.get("switch_time") is None
            and config.get("exact_hybrid_truths", False)
            and batches[0].switch_times is not None):
        switch_times = torch.stack([b.switch_times[:10] for b in batches])
    return dict(times=times, values=values, mask=mask,
                l_true=_rel_l_true(config, model, times, values, mask,
                                   switch_times))


def _population_winner(member_rows):
    """Best member by final val loss (train when no validation ran),
    NaN-safe: diverged members never win; all-NaN returns (None, by)
    (``njode_tpu/utils/training.py:1504-1514``)."""
    rows = member_rows["val"] or member_rows["train"]
    if not rows:
        return None, None
    by = "val" if member_rows["val"] else "train"
    arr = np.asarray(rows[-1], dtype=float)
    if np.all(np.isnan(arr)):
        return None, by
    return int(np.nanargmin(arr)), by


def _print_population_winner(lrs, member_rows):
    best, by = _population_winner(member_rows)
    if best is None:
        print("Population winner: none (every member's final loss is NaN)")
        return
    loss = float((member_rows[by])[-1][best])
    print(f"Population winner: lr={float(lrs[best]):g} (member {best}, "
          f"final {by} loss {loss:.6f})")


def _check_ensemble_state(model, stack, opt_states, n_seeds: int) -> None:
    """Raise unless a checkpoint holds a stack of n_seeds members of the
    model's architecture and one optimizer state a member."""
    sd = model.state_dict()
    if not isinstance(stack, dict) or stack.keys() != sd.keys():
        raise ValueError("the checkpoint holds no stack of this model's "
                         "state dict")
    for k, v in sd.items():
        if tuple(stack[k].shape) != (n_seeds, *v.shape):
            raise ValueError(f"{k}: {tuple(stack[k].shape)} in the "
                             f"checkpoint, ({n_seeds}, *{tuple(v.shape)}) "
                             "expected")
    if not isinstance(opt_states, list) or len(opt_states) != n_seeds:
        raise ValueError(f"the checkpoint holds no {n_seeds} optimizer "
                         "states")


def _run_ensemble_experiment(config: Dict, model, save_path,
                             n_seeds: int, mesh=None) -> Dict:
    """``run_experiment`` for ``config['ensemble'] = K > 1``
    (``njode_tpu/utils/training.py:1527-1741``): K members train with the
    experiment's recipe (:func:`..ensemble.train_ensemble_full`), each
    epoch recording every member's train, validation and relative loss;
    a checkpoint every ``print_every`` epochs and an exact resume.
    ``model.ckpt`` holds the stack, every member's optimizer state and the
    member loss matrices; ``history.json`` the single model's schema
    (means over the members) plus ``member_train_loss`` /
    ``member_val_loss`` / ``member_relative_loss``.  ``ensemble_lrs`` trains
    a population: the members differ in learning rate, share the data
    stream, and the best is printed and kept.  ``mesh``: each rank trains
    its block of the members (``njode_tpu/utils/training.py:1527-1545``);
    the checkpoints are collective, rank 0 writes history.json."""
    from ..parallel import is_primary
    from .ensemble import init_ensemble, population_adam, train_ensemble_full

    data = dict(config["data"])
    n_epochs = config["n_epochs"]
    print_every = config.get("print_every", 10)
    ckpt_path = str(save_path / "model.ckpt")
    backend = config.get("checkpoint_backend", "msgpack")
    lrs = config.get("ensemble_lrs") or None
    member_hparams = None
    if lrs is not None:
        if len(lrs) != n_seeds:
            raise ValueError(f"ensemble_lrs has {len(lrs)} values for "
                             f"ensemble={n_seeds}")
        tx = population_adam()
        member_hparams = {
            "learning_rate": [float(x) for x in lrs],
            "weight_decay": [float(config["weight_decay"])] * n_seeds}
        print(f"Population training: member learning rates {lrs}")
    else:
        lr, wd = config["learning_rate"], config["weight_decay"]

        def tx(params):
            return make_adam(params, lr, wd)
    share_data = lrs is not None
    n_val = int(data.get("n_val", 0) or 0)

    rel_eval = None
    try:
        rel_eval = _ensemble_rel_eval(config, model, n_seeds,
                                      share_data=share_data)
    except Exception as e:
        print(f"Warning: relative-loss setup failed: {e}")

    # ---- resume (reference utils/training.py:146-174 semantics) ----
    member_rows = {"train": [], "val": [], "rel": []}
    epoch_walls: List[float] = []
    initial_state, start_epoch, resumed = None, 0, False
    if config.get("resume_from_checkpoint", True) and checkpoint_exists(
            ckpt_path):
        try:
            stack, opt_states, hists = load_checkpoint(
                ckpt_path, map_location=model.device)
            _check_ensemble_state(model, stack, opt_states, n_seeds)
            for k in ("train", "val", "rel"):
                name = {"rel": "relative"}.get(k, k)
                member_rows[k] = [[float(x) for x in r] for r in
                                  hists.get(f"member_{name}_loss", [])]
            epoch_walls = list(hists.get("epoch_times", []))
            start_epoch = len(member_rows["train"])
            initial_state, resumed = (stack, opt_states), True
            print(f"Resuming {n_seeds}-member ensemble from epoch "
                  f"{start_epoch}")
        except Exception as e:
            print(f"Warning: Could not load ensemble checkpoint ({e}). "
                  f"Starting fresh.")
            member_rows = {"train": [], "val": [], "rel": []}
            epoch_walls, initial_state, start_epoch = [], None, 0

    def assemble_history() -> Dict:
        tr, va, re = (member_rows[k] for k in ("train", "val", "rel"))
        history = {
            "train_loss": [float(np.mean(r)) for r in tr],
            "val_loss": [float(np.mean(r)) for r in va],
            # the mean over members at the single model's print cadence
            "relative_loss": [float(np.mean(r)) for e, r in enumerate(re)
                              if e % print_every == 0],
            "epoch_times": list(epoch_walls),
            "member_train_loss": tr,
            "member_val_loss": va,
            "member_relative_loss": re,
            "n_ensemble": n_seeds,
        }
        if lrs is not None:
            history["ensemble_lrs"] = [float(x) for x in lrs]
            best, by = _population_winner(member_rows)
            if best is not None:
                history["best_member"] = best
                history["best_member_by"] = by
        if resumed:
            history["resumed_from_checkpoint"] = True
        return history

    def ckpt_histories() -> Dict:
        h = assemble_history()
        return {"train_losses": h["train_loss"], "val_losses": h["val_loss"],
                "epoch_times": h["epoch_times"],
                "relative_loss": h["relative_loss"],
                "member_train_loss": member_rows["train"],
                "member_val_loss": member_rows["val"],
                "member_relative_loss": member_rows["rel"]}

    def result(history, params_stack) -> Dict:
        return {"config": config, "history": history,
                "save_path": str(save_path),
                "final_train_loss": history["train_loss"][-1],
                "final_val_loss": (history["val_loss"][-1]
                                   if history["val_loss"] else None),
                "params_stack": params_stack}

    if start_epoch >= n_epochs:
        print(f"Training already completed ({start_epoch} epochs)")
        if lrs is not None:
            _print_population_winner(lrs, member_rows)
        return result(assemble_history(),
                      initial_state[0] if initial_state else init_ensemble(
                          model, n_seeds, seed=config.get("seed", 0)))

    member_rows_base = {k: list(v) for k, v in member_rows.items()}
    t_chunk = [time.perf_counter()]
    first_chunk = [True]

    def on_chunk(next_epoch, p, o, merged):
        now = time.perf_counter()
        new_rows = {k: [[float(x) for x in row] for row in v.tolist()]
                    for k, v in merged.items()}
        n_new = (len(new_rows["train"]) + len(member_rows_base["train"])
                 - len(member_rows["train"]))
        per_epoch = (now - t_chunk[0]) / max(n_new, 1)
        t_chunk[0] = now
        for k in ("train", "val", "rel"):
            if k in new_rows:
                member_rows[k] = member_rows_base[k] + new_rows[k]
        epoch_walls.extend([per_epoch] * n_new)
        h = assemble_history()
        msg = (f"Epoch {next_epoch - 1:4d} | Train Loss: "
               f"{h['train_loss'][-1]:.6f}")
        if h["val_loss"]:
            msg += f" | Val Loss: {h['val_loss'][-1]:.6f}"
        if h["relative_loss"]:
            msg += f" | Rel Loss: {h['relative_loss'][-1]:.4f}"
        msg += f" | Time: {per_epoch:.2f}s"
        # only the first progress line after a resume carries the marker
        if resumed and first_chunk[0]:
            msg += " (resumed)"
        first_chunk[0] = False
        print(msg, flush=True)
        save_checkpoint(ckpt_path, p, o, ckpt_histories(), backend=backend)

    params_stack, opt_states, _ = train_ensemble_full(
        model, data["process_type"], n_seeds=n_seeds, n_epochs=n_epochs,
        n_trajectories=data["n_train"], batch_size=config.get("batch_size"),
        obs_fraction=data.get("obs_fraction", 0.1), optimizer=tx,
        seed=config.get("seed", 0), data_seed=config.get("data_seed", 0),
        shuffle=config.get("shuffle", True),
        obs_only=bool(data.get("obs_only", False)),
        ignore_first_continuity=config.get("ignore_first_continuity", False),
        moment_weights=config.get("moment_weights"),
        variance_method=config.get("variance_method", "direct"),
        extended_moments=config.get("extended_moments", False),
        n_val=n_val, rel_eval=rel_eval, share_data=share_data,
        member_hparams=member_hparams, start_epoch=start_epoch,
        initial_state=initial_state, chunk_len=print_every,
        on_chunk=on_chunk, mesh=mesh, verbose=True,
        **{k: v for k, v in data.items()
           if k not in ("process_type", "n_train", "n_val", "obs_fraction",
                        "cache_data", "obs_only")})

    history = assemble_history()
    print(f"Trained {n_seeds}-member ensemble x {n_epochs - start_epoch} "
          f"epochs; final member losses "
          f"{[round(x, 4) for x in member_rows['train'][-1]]}")
    if lrs is not None:
        _print_population_winner(lrs, member_rows)
    save_checkpoint(ckpt_path, params_stack, opt_states, ckpt_histories(),
                    backend=backend)
    if is_primary():
        with open(save_path / "history.json", "w") as f:
            json.dump(history, f, indent=2)
    print(f"Experiment completed. Results saved to {save_path}")
    return result(history, params_stack)
