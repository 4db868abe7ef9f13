"""Training: Adam, data loaders, the Trainer and ``run_experiment`` (port of
``njode_tpu.utils.training``, one model on one device).

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
  ``simulation`` trains, and registered processes too.  Ensembles
  (ROADMAP Queue 1 item 11), data/model parallelism and multi-host runs
  (item 12) and Pallas interpret mode are not ported and raise
  ``NotImplementedError`` naming their item.
"""

from __future__ import annotations

import inspect
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from ..models import NeuralJumpODE, nj_ode_loss_dense, pad_ragged
from ..models.jump_ode import resolve_device
from ..simulation import TrajectoryBatch, simulate_batch
from ..simulation.moments import moments_at_obs
from .checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint

RELATIVE_LOSS_PROCESSES = ("black_scholes", "ornstein_uhlenbeck", "heston",
                           "hybrid_ou_bs")

# generator streams of stream_seed
STREAM_TRAIN, STREAM_VAL, STREAM_SHUFFLE, STREAM_DROPOUT = 0, 1, 2, 3


def make_adam(params, learning_rate: float,
              weight_decay: float = 0.0) -> torch.optim.Adam:
    """``torch.optim.Adam(lr, weight_decay)``: L2 into the gradient, then
    Adam with betas (0.9, 0.999) and eps 1e-8 (the JAX ``make_adam``,
    ``njode_tpu/utils/training.py:66``)."""
    return torch.optim.Adam(params, lr=learning_rate,
                            weight_decay=weight_decay)


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

    def _gen(self, epoch: int) -> TrajectoryBatch:
        gen = _generator(self.device,
                         stream_seed(self.seed, self.stream, epoch))
        return simulate_batch(self.n_trajectories, self.process_type,
                              self.obs_fraction, self.obs_only,
                              generator=gen, device=self.device,
                              **self.process_kwargs)

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
    """

    def __init__(self, model: NeuralJumpODE,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 device=None, ignore_first_continuity: bool = False,
                 moment_weights: Optional[List[float]] = None,
                 variance_method: str = "direct",
                 extended_moments: bool = False, seed: int = 0,
                 use_train_kernel=False,
                 train_kernel_opts: Optional[Dict] = None):
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
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self.epoch_times: List[float] = []
        self.relative_losses: List[float] = []
        self._epochs_run = 0          # epoch index of train_epoch calls

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
                     shuffle: bool):
        """(nb, bs) trajectory indices and validity of an epoch: a
        permutation from (seed, epoch), padded at the end with index 0."""
        dev = self.device
        if shuffle:
            gen = _generator(dev, stream_seed(self.seed, STREAM_SHUFFLE, epoch))
            perm = torch.randperm(n, generator=gen, device=dev)
        else:
            perm = torch.arange(n, device=dev)
        nb = -(-n // batch_size)
        n_pad = nb * batch_size
        idx = torch.cat([perm, torch.zeros(n_pad - n, dtype=perm.dtype,
                                           device=dev)])
        valid = torch.arange(n_pad, device=dev) < n
        return idx.reshape(nb, batch_size), valid.reshape(nb, batch_size)

    def _dropout_generator(self, epoch: int) -> Optional[torch.Generator]:
        if self.model.dropout_rate <= 0.0:
            return None
        return _generator(self.device,
                          stream_seed(self.seed, STREAM_DROPOUT, epoch))

    def _epoch_update(self, times, values, mask, epoch: int,
                      batch_size: Optional[int], shuffle: bool
                      ) -> torch.Tensor:
        """One composed epoch: a step of apply + loss + autograd + Adam per
        minibatch (reference utils/training.py:33-103).  Returns the mean of
        the minibatch losses, on the device."""
        n = times.shape[0]
        gen = self._dropout_generator(epoch)
        self.model.train()
        opt = self.optimizer
        if batch_size is None or batch_size >= n:
            opt.zero_grad(set_to_none=True)
            loss = self._loss(times, values, mask, generator=gen,
                              training=True)
            loss.backward()
            opt.step()
            return loss.detach()
        idx, valid = self._minibatches(epoch, n, batch_size, shuffle)
        losses = []
        for ids, vm in zip(idx, valid):
            opt.zero_grad(set_to_none=True)
            loss = self._loss(times[ids], values[ids], mask[ids],
                              traj_mask=vm, generator=gen, training=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    def _kernel_hparams(self) -> dict:
        g = self.optimizer.param_groups[0]
        return {"lr": float(g["lr"]), "weight_decay": float(g["weight_decay"]),
                "betas": tuple(float(b) for b in g["betas"]),
                "adam_eps": float(g["eps"])}

    def _twin(self) -> str:
        """The whole-run kernel of the model's recipe: "walk" with
        ``dt_ode_step`` (``njode_tpu/utils/training.py:951``), else "run"."""
        return "walk" if self.model.dt_ode_step is not None else "run"

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
        hp = self._kernel_hparams()
        mw = tuple(self.moment_weights) if self.moment_weights else (1.0, 1.0)
        kw = dict(n_slots=times.shape[1], num_moments=m.num_moments,
                  batch_size=bs, activation=m._act_key,
                  input_scaling=m._scale_key, lr=hp["lr"],
                  weight_decay=hp["weight_decay"], moment_weights=mw,
                  variance_method=self.variance_method, betas=hp["betas"],
                  adam_eps=hp["adam_eps"], mxu_dtype=self._mxu_dtype())
        opt_sd = self.optimizer.state_dict()
        with torch.no_grad():
            if self._twin() == "walk":
                m._check_grid_alignment(times, None)
                state = wt.walk_state_from(m, opt_sd, betas=hp["betas"])
                state, losses = wt.fused_walk_train_run(
                    state, data, hidden_dim=m.hidden_dim,
                    dt_ode_step=m.dt_ode_step,
                    max_substeps=walk_cells(m), ode_solver=m.ode_solver,
                    **kw)
                sd, osd = wt.optax_state_into_walk(state, idx.shape[0],
                                                   opt_sd, m)
            else:
                state = tk.kernel_state_from(m, opt_sd, betas=hp["betas"])
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
            return float(self._loss(times, values, mask_))

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
            L_model = float(self._loss_no_first(rel["times"], rel["values"],
                                                rel["mask"]))
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
        train this setup (``njode_tpu/utils/training.py:379-416``, with the
        port's own gates on the shapes and on the batch's ``mask``)."""
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
        if not batch_size_ok(batch_size):
            problems.append("batch_size must be given (a positive integer)")
        if mask is not None and not bool(mask.all()):
            problems.append("the batch has padded slots (its mask is not "
                            "all True); the kernel takes every slot as an "
                            "observation")
        problems += self._kernel_opts_problems()
        if problems:
            raise ValueError("train kernel not applicable: "
                             + "; ".join(problems))

    def _walk_train_check(self, batch_size: Optional[int],
                          n_slots: Optional[int] = None,
                          mask: Optional[torch.Tensor] = None) -> None:
        """Raise, listing every problem, when the walk-train kernel cannot
        train this setup (``njode_tpu/utils/training.py:461-512``, with the
        port's own shape gate and the batch's ``mask``)."""
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
        problems += self._kernel_opts_problems()
        if problems:
            raise ValueError("train kernel (walk twin) not applicable: "
                             + "; ".join(problems))

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
        if self.use_train_kernel is False:
            return False
        check = (self._walk_train_check if self._twin() == "walk"
                 else self._train_kernel_check)
        if self.use_train_kernel == "auto":
            if self.device.type != "cuda":
                return False
            try:
                check(batch_size, n_slots, mask)
            except ValueError:
                return False
            return True
        check(batch_size, n_slots, mask)
        return True

    # ---------------------------------------------------------------- train

    def train(self, train_data_fn: Callable,
              val_data_fn: Optional[Callable] = None, n_epochs: int = 100,
              batch_size: Optional[int] = None, shuffle: bool = True,
              print_every: int = 10, save_path: Optional[str] = None,
              resume_from_checkpoint: bool = True,
              config: Optional[Dict] = None) -> Dict:
        """The epoch loop (reference utils/training.py:126-287)."""
        start_epoch = 0
        if resume_from_checkpoint and checkpoint_exists(save_path):
            print(f"Found existing checkpoint at {save_path}")
            try:
                self.load_model(save_path)
                start_epoch = len(self.train_losses)
                best = min(self.train_losses) if self.train_losses else float("nan")
                print(f"Resuming from epoch {start_epoch} "
                      f"(previous best loss: {best:.6f})")
                if start_epoch >= n_epochs:
                    print(f"Training already completed ({start_epoch} >= "
                          f"{n_epochs} epochs)")
                    return {"train_loss": self.train_losses,
                            "val_loss": self.val_losses,
                            "epoch_times": self.epoch_times,
                            "relative_loss": self.relative_losses,
                            "resumed_from_checkpoint": True}
            except Exception as e:  # fresh training, like the reference
                print(f"Warning: Could not load checkpoint ({e}). "
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
                use_kernel = self._use_kernel(batch_size, times.shape[1],
                                              mask)
                kernel = ("walk-train kernel" if self._twin() == "walk"
                          else "whole-run kernel")
                if self._mxu_dtype() != "float32":
                    kernel += f" ({self._mxu_dtype()} products)"
                # every minibatch has batch_size rows (_minibatches pads)
                forced = self.model._forced_route()
                comp = ("composed (fused-step kernels)"
                        if self.model._use_fused_step(times.shape[1],
                                                      batch_size)
                        else f"composed (forced {forced})" if forced
                        else "composed")
                print(f"Training path: "
                      f"{kernel if use_kernel else comp} "
                      f"from epoch {epoch} (use_train_kernel="
                      f"{self.use_train_kernel!r}, device {self.device})",
                      flush=True)
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
                print(msg, flush=True)
                if save_path is not None:
                    self.save_model(save_path)

        if save_path is not None:
            self.save_model(save_path)
        return history

    # ------------------------------------------------------------- persist

    def _histories(self):
        return {"train_losses": self.train_losses,
                "val_losses": self.val_losses,
                "epoch_times": self.epoch_times,
                "relative_loss": self.relative_losses}

    def save_model(self, path: str):
        save_checkpoint(path, self.model.state_dict(),
                        self.optimizer.state_dict(), self._histories())

    def load_model(self, path: str):
        sd, osd, hist = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(sd)
        self.optimizer.load_state_dict(osd)
        self.train_losses = hist["train_losses"]
        self.val_losses = hist["val_losses"]
        self.epoch_times = hist["epoch_times"]
        self.relative_losses = hist["relative_loss"]


# --------------------------------------------------------------------------
# run_experiment
# --------------------------------------------------------------------------

def _refuse_unported(config: Dict) -> None:
    """NotImplementedError for every config option whose path is not
    ported, naming its ROADMAP.md item."""
    if int(config.get("ensemble", 0) or 0) > 1 or config.get("ensemble_lrs"):
        raise NotImplementedError("ensembles are not ported yet (ROADMAP.md, "
                                  "Queue 1 item 11)")
    if (int(config.get("data_parallel", 0) or 0) > 1
            or int(config.get("model_parallel", 1) or 1) > 1
            or config.get("multihost", False)):
        raise NotImplementedError(
            "data/model parallelism and multi-host runs are not ported yet "
            "(ROADMAP.md, Queue 1 item 12)")
    # "msgpack" names the JAX package's single-file checkpoint; the port's
    # single file is a torch.save bundle
    if config.get("checkpoint_backend", "msgpack") != "msgpack":
        raise NotImplementedError("Orbax checkpoints are not ported; the "
                                  "port writes one torch.save file "
                                  "(ROADMAP.md, Queue 1 item 12)")
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
                       use_pallas_cfg=None) -> bool:
    """The grid-walk policy (``njode_tpu/utils/training.py:1162-1219``):
    "on" walks, "off" keeps the per-gap loops, and "auto" walks exactly
    where a CUDA kernel carries the walk: the model on ``cuda``, kernels
    asked for (use_pallas "auto", "train" or True), the config eligible for
    the walk kernels (euler) or the walk-train kernel (heun, rk4), and the
    data aligned to the grid.  The port runs one model on one device, so the
    JAX package's single-device condition always holds.  Off the card
    "auto" resolves off, as the JAX package does off the TPU."""
    setting = config.get("grid_walk", "auto")
    dt = config.get("dt_ode_step")
    if dt is None or setting in (False, "off", None):
        return False
    if setting in (True, "on"):
        return True
    if device.type != "cuda" or use_pallas_cfg not in ("auto", "train",
                                                       True):
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
                   use_pallas_cfg=None) -> bool:
    """Resolve the grid walk and refuse a misaligned "on" from the static
    config (``njode_tpu/utils/training.py:1235-1255``)."""
    if not _resolve_grid_walk(config, device, use_pallas_cfg):
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


def run_experiment(config: Dict, save_dir: str = "runs") -> Dict:
    """A whole training experiment (reference utils/training.py:349-438), one
    model on one device: ``runs/<experiment_name>/{config.json, model.ckpt,
    history.json}``."""
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
    _refuse_unported(config)
    # config "device": "auto" or absent means cuda (raising without one),
    # "cpu" the CPU, any other torch device string as given
    device = resolve_device(config.get("device", "auto"))
    save_path = Path(save_dir) / config["experiment_name"]
    save_path.mkdir(parents=True, exist_ok=True)
    with open(save_path / "config.json", "w") as f:
        json.dump(config, f, indent=2)
    print(f"Device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    # use_pallas 'auto' (the CLI default) and 'train' select the whole-run
    # training kernel of the model's twin, quietly and insistently
    # (njode_tpu/utils/training.py:1338-1348); the model keeps 'auto' for
    # its own kernels (the gap kernel, the walk kernels), and 'step' and
    # True go to the model (its fused-step kernels, its forced per-gap
    # kernels) with the whole-run kernels off
    up = config.get("use_pallas", False)
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
        # grid promise (njode_tpu/utils/training.py:1381-1384)
        grid_walk=_use_grid_walk(config, device, up),
        device=device,
        generator=torch.Generator().manual_seed(int(config.get("seed", 0))))
    optimizer = make_adam(model.parameters(), config["learning_rate"],
                          config["weight_decay"])
    trainer = Trainer(
        model, optimizer,
        ignore_first_continuity=config.get("ignore_first_continuity", False),
        moment_weights=config.get("moment_weights"),
        variance_method=config.get("variance_method", "direct"),
        extended_moments=config.get("extended_moments", False),
        seed=config.get("seed", 0), use_train_kernel=use_train_kernel,
        train_kernel_opts={"mxu_dtype": config.get("train_kernel_mxu",
                                                   "float32")})
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
    with open(save_path / "history.json", "w") as f:
        json.dump(history, f, indent=2)
    print(f"Experiment completed. Results saved to {save_path}")
    return {"config": config, "history": history,
            "save_path": str(save_path),
            "final_train_loss": history["train_loss"][-1],
            "final_val_loss": (history["val_loss"][-1]
                               if history["val_loss"] else None)}
