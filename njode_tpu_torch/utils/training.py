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
  one call of :func:`njode_tpu_torch.ops.fused_train_run` (the whole-run
  CUDA kernel on the card, its plain version on the CPU), converting the
  Adam state at each call, so checkpoints of either path resume on the
  other.  Both paths see the same minibatches: the shuffle of an epoch
  comes from (seed, epoch).
* Checkpoints keep the reference's semantics: ``start_epoch =
  len(train_losses)``, an early return when training is complete, a fresh
  start when the checkpoint cannot be loaded (reference
  utils/training.py:146-174).
* :func:`run_experiment` writes ``runs/<name>/{config.json, model.ckpt,
  history.json}``.  Ensembles, data/model parallelism, multi-host runs, the
  grid walk, mixed precision and the fused-step/cell kernels are not ported
  and raise ``NotImplementedError`` naming their ROADMAP item.
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

RELATIVE_LOSS_PROCESSES = ("black_scholes",)

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
    model is on CUDA and :meth:`_train_kernel_check` passes, the composed
    path otherwise; ``True`` takes the kernel and raises where the
    configuration is not eligible (on CPU tensors the kernel's plain version
    runs); ``False`` (default) takes the composed path.
    """

    def __init__(self, model: NeuralJumpODE,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 device=None, ignore_first_continuity: bool = False,
                 moment_weights: Optional[List[float]] = None,
                 variance_method: str = "direct",
                 extended_moments: bool = False, seed: int = 0,
                 use_train_kernel=False):
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
        self.ignore_first_continuity = ignore_first_continuity
        self.moment_weights = list(moment_weights) if moment_weights else None
        self.variance_method = variance_method
        self.extended_moments = extended_moments
        self.seed = seed
        self.use_train_kernel = use_train_kernel
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

    def _kernel_epoch(self, times, values, epoch: int,
                      batch_size: Optional[int], shuffle: bool
                      ) -> torch.Tensor:
        """One epoch as one call of the whole-run kernel (the plain version
        for a CPU model), the Adam state converted in and out.  The same
        minibatches as :meth:`_epoch_update`.  The kernel takes every slot
        as an observation: :meth:`train` sends it only batches whose mask is
        full."""
        from ..ops.train_kernel import (fused_train_run, kernel_state_from,
                                        optax_state_into, pack_minibatches)
        m = self.model
        n = times.shape[0]
        bs = batch_size if batch_size is not None else n
        idx, valid = self._minibatches(epoch, n, bs, shuffle)
        ids = idx.reshape(-1)
        data = pack_minibatches(times[ids], values[ids], valid.reshape(-1), bs)
        hp = self._kernel_hparams()
        mw = tuple(self.moment_weights) if self.moment_weights else (1.0, 1.0)
        with torch.no_grad():
            state = kernel_state_from(m, self.optimizer.state_dict(),
                                      betas=hp["betas"])
            state, losses = fused_train_run(
                state, data, n_slots=times.shape[1],
                num_moments=m.num_moments, batch_size=bs,
                activation=m._act_key, input_scaling=m._scale_key,
                lr=hp["lr"], weight_decay=hp["weight_decay"],
                moment_weights=mw, variance_method=self.variance_method,
                betas=hp["betas"], adam_eps=hp["adam_eps"])
            sd, osd = optax_state_into(state, idx.shape[0],
                                       self.optimizer.state_dict(), m)
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
        (reference utils/training.py:184-196,219-255); None for processes
        without ported truths."""
        data_cfg = config["data"]
        process_type = data_cfg["process_type"]
        if process_type not in RELATIVE_LOSS_PROCESSES:
            return None
        times, values, mask, _ = as_dense(_call_data_fn(train_data_fn, 0),
                                          self.device)
        times, values, mask = times[:10], values[:10], mask[:10]
        params = {k: v for k, v in data_cfg.items() if k != "process_type"}
        y_true, y_true_before = moments_at_obs(
            times, values, process_type, num_moments=self.model.num_moments,
            variance_method=self.variance_method, mask=mask, **params)
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
                            "(hidden_dim a multiple of 4, at least 2 slots, "
                            "one warp's working set in shared memory)")
        if m.dtype != torch.float32:
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

    def _kernel_opts_problems(self) -> list:
        """The kernel implements ``torch.optim.Adam`` with L2 weight decay
        and reads its hyperparameters from the optimizer's one param
        group."""
        opt = self.optimizer
        if type(opt) is not torch.optim.Adam:
            return [f"the optimizer is {type(opt).__name__}; the kernel "
                    "implements torch.optim.Adam"]
        problems = []
        if len(opt.param_groups) != 1:
            problems.append("one optimizer param group only")
        for flag in ("amsgrad", "maximize", "decoupled_weight_decay"):
            if opt.param_groups[0].get(flag, False):
                problems.append(f"Adam {flag}=True unsupported")
        return problems

    def _use_kernel(self, batch_size: Optional[int], n_slots: int,
                    mask: Optional[torch.Tensor] = None) -> bool:
        """Resolve ``use_train_kernel`` for a batch of this run."""
        if self.use_train_kernel is False:
            return False
        if self.use_train_kernel == "auto":
            if self.device.type != "cuda":
                return False
            try:
                self._train_kernel_check(batch_size, n_slots, mask)
            except ValueError:
                return False
            return True
        self._train_kernel_check(batch_size, n_slots, mask)
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
                print(f"Training path: "
                      f"{'whole-run kernel' if use_kernel else 'composed'} "
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
    if (config.get("dt_ode_step") is not None
            and config.get("grid_walk", "auto") in (True, "on")):
        raise NotImplementedError("grid_walk on: the grid walk is not ported "
                                  "yet (ROADMAP.md, Queue 1 item 7)")
    if config.get("compute_dtype") not in (None, "float32", "none"):
        raise NotImplementedError("compute_dtype: mixed precision is not "
                                  "ported yet (ROADMAP.md, Queue 2 "
                                  "fused_step)")
    up = config.get("use_pallas", False)
    if up is True or up in ("interpret", "step", "step-interpret"):
        raise NotImplementedError(
            f"use_pallas={up!r}: the fused Euler cell and fused-step kernels "
            "are not ported yet (ROADMAP.md, Queue 2 rows 6, 9-10)")
    if up not in (False, None, "auto", "train"):
        raise ValueError(f"Unknown use_pallas: {up!r}")
    if config.get("train_kernel_mxu", "float32") != "float32":
        raise NotImplementedError("train_kernel_mxu: the port's training "
                                  "kernel runs float32 only")
    process = config.get("data", {}).get("process_type", "black_scholes")
    if process != "black_scholes":
        raise NotImplementedError(f"process {process!r} is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 9)")


def run_experiment(config: Dict, save_dir: str = "runs") -> Dict:
    """A whole training experiment (reference utils/training.py:349-438), one
    model on one device: ``runs/<experiment_name>/{config.json, model.ckpt,
    history.json}``."""
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
    # training kernel, quietly and insistently (njode_tpu/utils/training.py:
    # 1338-1348); the model keeps 'auto' for its inference-side gap kernel
    up = config.get("use_pallas", False)
    use_train_kernel = {"auto": "auto", "train": True}.get(up, False)
    model = NeuralJumpODE(
        input_dim=config["input_dim"], hidden_dim=config["hidden_dim"],
        output_dim=config["output_dim"],
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
        ode_solver=config.get("ode_solver", "euler"),
        use_pallas="auto" if up == "auto" else False,
        debug_checks=config.get("debug_checks", False),
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
        seed=config.get("seed", 0), use_train_kernel=use_train_kernel)
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
