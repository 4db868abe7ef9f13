"""Neural Jump ODE in PyTorch: the serving slice of ``njode_tpu.models.jump_ode``.

The model answers conditional-moment queries: the jump network resets the
latent state at every observation, the ODE drift integrates it across the
gap to the query time, and the readout maps it to the moments.  Every query
integrates independently from the state at its own last observation, so all
B*Q queries of a :meth:`NeuralJumpODE.predict_at` call run as one batch.

Semantics kept from the JAX package (and the reference it mirrors):

* ODEFunc time features are *substep-relative*: ``t_rel = t_cur`` (substep
  start) and ``t_elapsed = t_new - t_cur`` (reference models/jump_ode.py:
  59-61).
* ``dt_ode_step=None``: one Euler step spans the whole gap (reference
  :188-190).  A fixed ``dt_ode_step``: ``while t + dt < t_next`` full steps,
  with t accumulated in floating point, then a final partial step to exactly
  ``t_next`` (reference :196-202).
* The prediction before the first observation is identically zero
  (reference :161).

Where the ODEFunc is one the CUDA kernel computes (``gap_scan_available``:
one hidden layer, no dropout, euler) and ``dt_ode_step`` is set, a gap
integrated for inference (``predict_at``, the filter, ``apply`` under
``torch.no_grad()``) goes through
:func:`njode_tpu_torch.ops.integrate_gap_fused`: the CUDA kernel for CUDA
tensors, its plain version on the CPU.  A gap that autograd differentiates
takes the plain substep loop, as the JAX package's ``"auto"`` policy sends
training to XLA (``njode_tpu/models/jump_ode.py:301-310``), except under
``use_pallas=True`` (the CLI's ``--kernels force``): there it takes the
gap loop's training kernels (forward with residuals, reverse-loop
backward) wherever ``gap_train_fits``, and every Euler step the model takes
outside them goes through the fused Euler cell
(:func:`njode_tpu_torch.ops.fused_cell.ode_euler_fused`): each gap of a
model without ``dt_ode_step``, the plain loop's substeps and the plain
walk's cells (``_use_fused``, ``_use_gap_scan``).

``grid_walk=True`` (it needs ``dt_ode_step``) is the caller's promise that
every valid observation time sits on the grid ``{g * dt_ode_step}``;
``apply`` then integrates all gaps in one time-major walk over the grid
(``_integrate_gaps_grid``).  With ``use_pallas="auto"`` the walk runs in
the CUDA kernel pair of :func:`njode_tpu_torch.ops.walk_gaps_fused`
(forward and backward, so training goes through it too; its plain version
on the CPU) wherever ``_use_walk_kernel`` holds, and the per-gap path
elsewhere; with ``use_pallas=False`` it runs the plain walk with the XLA
walk's time features, as the JAX package's ``False`` does.

Training: :meth:`NeuralJumpODE.apply` is the dense slot-batched forward
(jump at every slot, one integration per gap, readouts), ``apply_loss``
composes it with :func:`nj_ode_loss_dense`, and ``forward`` is the ragged
reference API.  Dropout in training mode draws from an explicit
``torch.Generator``; without one no dropout is applied, as the JAX model
applies none without an rng.  With ``use_pallas="step"`` (the scaled
recipe) ``apply``, and so ``apply_loss``, goes through the fused
whole-step kernels of :mod:`njode_tpu_torch.ops.fused_step` wherever
``_use_fused_step`` holds (no dropout, no
``dt_ode_step``, euler, shapes within ``fused_step_fits``): the CUDA
kernels for CUDA tensors, their plain versions on the CPU.  ``"auto"``
takes them on the card only at the shape an H100 A/B had them ahead
(the scaled recipe's: hidden 256, two slots, >= 4,096 rows), in float32
and in bfloat16.

Mixed precision (``compute_dtype``, ``njode_tpu/models/jump_ode.py:150-157``
and ``_mp``/``_mp_in``/``_mp_out`` ``:346-357``): bfloat16 or float16 runs
the three networks in that dtype (weights and input cast, products, biases,
activations and dropout in it, the output cast back), while the parameters,
the solver's carry and the time features stay in ``dtype``.  As in the JAX
package, the gap, fused-cell and walk kernels are float32 only, so a model
with a compute dtype takes the composed route for them; the fused step
takes bfloat16 (its bf16 kernels, :mod:`njode_tpu_torch.ops.fused_step`)
but not float16.

The model's device defaults to ``cuda``; the CPU is used only when asked
for (``device="cpu"``).  Without a CUDA device the default raises.

:meth:`NeuralJumpODE.predict_on_grid` is the dense-grid rollout that
plotting uses: a plain loop of ``_euler`` substeps, each through the fused
Euler cell where ``_use_fused`` holds, as in the JAX package.

Not ported (ROADMAP.md): Pallas interpret mode (``"interpret"``,
``"step-interpret"``); the constructor arguments that select it raise.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import (GapWeights, gap_scan_available, integrate_gap_fused,
                   split_weights)
from ..ops import fused_cell, fused_step, gap_scan, walk_scan
from .activations import (canonical_activation, canonical_input_scaling,
                          get_input_scaling)
from .loss import nj_ode_loss_dense
from .mlp import JumpNN, ODEFunc, OutputNN, linears


def resolve_device(device=None) -> torch.device:
    """The port's device rule: None or ``"auto"`` means ``cuda`` and raises
    when no CUDA device exists; anything else is taken as given (the CPU
    only when asked for)."""
    if device is None or device == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "njode_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


_COMPUTE_DTYPES = {"float32": None, "none": None,
                   "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                   "float16": torch.float16, "fp16": torch.float16}


def parse_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """The JAX package's names (``njode_tpu/models/jump_ode.py:150-157``):
    None, "float32" and "none" mean full precision (None); "bfloat16" /
    "bf16" and "float16" / "fp16" their torch dtypes, which are also taken
    as given; anything else raises ``ValueError``."""
    if compute_dtype is None or compute_dtype in (torch.bfloat16,
                                                  torch.float16):
        return compute_dtype
    if (isinstance(compute_dtype, str)
            and compute_dtype.lower() in _COMPUTE_DTYPES):
        return _COMPUTE_DTYPES[compute_dtype.lower()]
    raise ValueError(f"Unknown compute_dtype: {compute_dtype}")


def run_net(net: nn.Module, x: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A network's layers in order, with inverted dropout (torch's
    train-mode law) drawn from ``generator`` where one is given, and no
    dropout otherwise, whatever the module's train/eval mode.

    With a ``compute_dtype`` the input and each Linear's weights are cast to
    it and every layer runs in it, a Linear as ``x @ w + b`` (two roundings,
    as the JAX package's ``_linear``); the output is cast back to the
    input's dtype.  Autograd carries the gradients back through the casts
    in the parameters' own dtype."""
    out_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for layer in net.net:
        if isinstance(layer, nn.Dropout):
            if generator is not None and layer.p > 0.0:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) >= layer.p
                x = torch.where(keep, x / (1.0 - layer.p), 0.0)
        elif compute_dtype is not None and isinstance(layer, nn.Linear):
            x = (x @ layer.weight.to(compute_dtype).t()
                 + layer.bias.to(compute_dtype))
        else:
            x = layer(x)
    return x.to(out_dtype)


def _raise_on_grid_misalignment(bad: bool, worst: float,
                                dt_ode_step: float) -> None:
    """The ``debug_checks`` grid-walk alignment refusal
    (``njode_tpu/models/jump_ode.py:85``)."""
    if bad:
        raise ValueError(
            f"grid_walk=True but an observation time is off the integration "
            f"grid (worst offset {float(worst):.3g} from a multiple of "
            f"dt_ode_step={float(dt_ode_step)}) or beyond it; disable "
            "grid_walk for off-grid data or enlarge t_max.")


class NeuralJumpODE(nn.Module):
    """Neural Jump ODE with the JAX model's constructor signature.

    Port-specific arguments:
      device:    where the parameters live: None (default) means ``cuda``
                 and raises without a CUDA device; pass ``"cpu"`` for the
                 CPU (see :func:`resolve_device`).
      generator: the ``torch.Generator`` the init draws from; None means a
                 CPU generator seeded with 0.  Weights are drawn on the CPU
                 and then moved, so a seed gives the same model everywhere.
      use_pallas: "auto" (default), False, "step" or True, kept for the
                 JAX signature.  The gap kernel runs for inference wherever
                 it applies under all four; the grid walk takes its kernel
                 pair under "auto" and True and its plain walk under False,
                 as in the JAX package; "step" takes the fused whole-step
                 kernels, and "auto" takes them on the card at the shape an
                 H100 A/B measured ahead (:meth:`_use_fused_step`); True
                 forces the per-gap kernels: the gap loop's training pair
                 under autograd and the fused Euler cell for every other
                 Euler step (:meth:`_use_gap_scan`, :meth:`_use_fused`).
                 "interpret" and "step-interpret" select Pallas interpret
                 mode, which has no port, and raise: on the CPU, True and
                 "step" run the kernels' plain versions.
      compute_dtype: None / "float32" (full precision), "bfloat16" or
                 "float16" (:func:`parse_compute_dtype`): the networks'
                 dtype; the parameters stay ``dtype``.  Under a compute
                 dtype no gap, cell or walk kernel runs, and "step" takes
                 the fused step's bf16 kernels for bfloat16 only.
    """

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 dt_between_obs: Optional[float] = None,
                 dt_ode_step: Optional[float] = None,
                 num_moments: int = 1, n_hidden_layers: int = 1,
                 activation: str = "relu", shared_network: bool = False,
                 dropout_rate: float = 0.0, input_scaling: str = "identity",
                 variance_method: str = "direct",
                 t_max: float = 1.0, max_substeps: Optional[int] = None,
                 use_pallas="auto", dtype: torch.dtype = torch.float32,
                 compute_dtype=None, ode_solver: str = "euler",
                 debug_checks: bool = False, grid_walk: bool = False, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if grid_walk and dt_ode_step is None:
            raise ValueError("grid_walk=True requires dt_ode_step (gaps "
                             "without substeps are already a single step)")
        if use_pallas == "step-interpret":
            raise NotImplementedError(
                "use_pallas='step-interpret' runs the fused training-step "
                "kernel in Pallas interpret mode, which has no port: on the "
                "CPU use 'step', whose wrappers take the kernels' plain "
                "versions for CPU tensors")
        if use_pallas == "interpret":
            raise NotImplementedError(
                "use_pallas='interpret' runs the gap-loop and fused Euler "
                "cell kernels in Pallas interpret mode, which has no port: "
                "on the CPU use True, whose wrappers take the kernels' plain "
                "versions for CPU tensors")
        if use_pallas not in ("auto", False, "step", True):
            raise ValueError(f"Unknown use_pallas: {use_pallas!r}")
        if ode_solver not in ("euler", "heun", "rk4"):
            raise ValueError(f"Unknown ode_solver: {ode_solver!r} "
                             "(one of 'euler', 'heun', 'rk4')")
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim
        self.dt_between_obs = dt_between_obs  # deprecated in the reference
        self.dt_ode_step = dt_ode_step
        self.num_moments = num_moments
        self.n_hidden_layers = n_hidden_layers
        self.activation = activation
        self.shared_network = shared_network
        self.dropout_rate = dropout_rate
        self.input_scaling = input_scaling
        self.variance_method = variance_method
        self.t_max = t_max
        self.use_pallas = use_pallas
        # the parameters' dtype; the networks compute in compute_dtype
        self.dtype = dtype
        self.compute_dtype = parse_compute_dtype(compute_dtype)
        self.ode_solver = ode_solver
        self.debug_checks = debug_checks
        self.grid_walk = bool(grid_walk)

        self._scale = get_input_scaling(input_scaling)
        # the names the activation/scaling resolve to; kernel eligibility
        # and the kernel's enums consume these, never the raw strings
        self._act_key = canonical_activation(activation)
        self._scale_key = canonical_input_scaling(input_scaling)

        if max_substeps is not None:
            self.max_substeps = max_substeps
        elif dt_ode_step is not None:
            # a gap never exceeds t_max, so at most ceil(t_max/dt) full
            # substeps occur before the final partial step
            self.max_substeps = int(math.ceil(t_max / dt_ode_step))
        else:
            self.max_substeps = 0

        # shared mode carries one latent state for all moments
        self.k_hidden = 1 if shared_network else num_moments
        self._gap_eligible = (ode_solver == "euler" and gap_scan_available(
            n_hidden_layers, self._act_key, dropout_rate, self._scale_key))
        # the fused Euler cell (use_pallas=True): one Euler step a launch
        self._fused_eligible = (ode_solver == "euler"
                                and fused_cell.fused_cell_available(
                                    n_hidden_layers, self._act_key,
                                    dropout_rate))
        # the fused whole-step kernels (use_pallas="step"): jump -> one
        # Euler step per gap -> readout, all slots in two kernels
        self._step_eligible = fused_step.fused_step_available(
            shared_network, input_dim, output_dim, n_hidden_layers,
            self._act_key, dropout_rate, self._scale_key, dt_ode_step,
            ode_solver)
        # (parameter versions, GapWeights): the kernel's weights, cut once
        self._gap_cache: Optional[tuple] = None

        gen = torch.Generator().manual_seed(0) if generator is None else generator
        net = dict(n_hidden_layers=n_hidden_layers, activation=activation,
                   dropout_rate=dropout_rate, generator=gen)
        if shared_network:
            self.jump_nn = JumpNN(input_dim, hidden_dim, **net)
            self.ode_func = ODEFunc(hidden_dim, input_dim, **net)
            self.output_nn = OutputNN(hidden_dim, output_dim * num_moments,
                                      **net)
        else:
            self.jump_nns = nn.ModuleList(
                JumpNN(input_dim, hidden_dim, **net) for _ in range(num_moments))
            self.ode_funcs = nn.ModuleList(
                ODEFunc(hidden_dim, input_dim, **net)
                for _ in range(num_moments))
            self.output_nns = nn.ModuleList(
                OutputNN(hidden_dim, output_dim, **net)
                for _ in range(num_moments))
        self.to(device=resolve_device(device), dtype=dtype)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @contextlib.contextmanager
    def _inference(self):
        """No autograd and no dropout (eval mode) inside; mode restored after."""
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            self.train(was_training)

    def _as_tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype or self.dtype, device=self.device)

    # ------------------------------------------------------------- sub-nets

    def _ode_nets(self) -> list[ODEFunc]:
        return [self.ode_func] if self.shared_network else list(self.ode_funcs)

    def _gap_weights(self) -> GapWeights:
        """The ODEFunc(s)' weights as the gap kernel takes them, stacked on
        K_h, for inference only.  Cut once and kept until a parameter moves
        (``.to``) or a write bumps its version (``load_state_dict``, the
        default foreach ``torch.optim.Adam`` step), or until
        :meth:`_drop_gap_cache`: a :class:`~njode_tpu_torch.utils.Trainer`
        calls it after every step of its optimizer, so a fused Adam step,
        which keeps the versions, refreshes the cut too.  Writes that keep
        the version outside a Trainer (through ``.data``, a fused optimizer
        stepped by hand) need that call.  A gap that autograd
        differentiates cuts them anew (``split_weights(self._ode_weights())``):
        a cut kept from a no-grad call carries no graph, and its weights
        would train with no gradient."""
        params = self._ode_params()
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._gap_cache is None or self._gap_cache[0] != key:
            self._gap_cache = (key, split_weights(self._ode_weights()))
        return self._gap_cache[1]

    def _drop_gap_cache(self, *_args) -> None:
        """Forget the inference weights' cut; the next inference gap cuts
        them anew.  Takes and ignores an optimizer step hook's arguments."""
        self._gap_cache = None

    def _ode_params(self) -> list[torch.Tensor]:
        """W1, b1, W2, b2 of each ODEFunc in turn."""
        return [p for l1, l2 in map(linears, self._ode_nets())
                for p in (l1.weight, l1.bias, l2.weight, l2.bias)]

    def _ode_weights(self) -> list[torch.Tensor]:
        """(W1, b1, W2, b2), each stacked on K_h in torch's orientation,
        differentiable."""
        params = self._ode_params()
        return [torch.stack(params[i::4]) for i in range(4)]

    def _use_walk_kernel(self, inference: bool = False) -> bool:
        """Route the grid walk through the walk kernels
        (:func:`njode_tpu_torch.ops.walk_gaps_fused`): under
        ``use_pallas="auto"``, wherever ``walk_scan_available`` holds and the
        solver is euler (CUDA tensors take the kernels, CPU tensors their
        plain version).  A walk without autograd on the card takes the
        per-gap route with the gap kernel instead: there the walk route's
        grid guard (one host read) cost more than the walk kernel saves,
        at 256 and 2,000 rows on an H100 (PERF.md)."""
        if (self.use_pallas is False or self.ode_solver != "euler"
                or self.compute_dtype is not None):
            return False
        if inference and self.device.type == "cuda":
            return False
        return walk_scan.walk_scan_available(
            self.n_hidden_layers, self._act_key, self.dropout_rate,
            self._scale_key, self.input_dim, self.hidden_dim)

    def _use_fused(self) -> bool:
        """Route ``_euler``'s Euler steps through the fused Euler cell
        (``njode_tpu/models/jump_ode.py:270-273``): only when forced,
        ``use_pallas=True``, for an eligible ODEFunc without a compute dtype
        (CUDA tensors take the kernel, CPU tensors its plain version)."""
        return (self._fused_eligible and self.use_pallas is True
                and self.compute_dtype is None)

    def _use_gap_scan(self, inference: bool = False) -> bool:
        """Route a ``dt_ode_step`` gap through the gap kernels
        (``njode_tpu/models/jump_ode.py:301-310``) for an eligible ODEFunc.
        Under every policy a gap integrated for inference takes the
        primal-only kernel (the port's "auto" has no row gate: the JAX one,
        ``AUTO_MAX_ROWS``, was measured on the TPU).  Under ``use_pallas=
        True`` a gap under autograd takes the training pair too, where
        ``gap_train_fits`` holds, and ``debug_checks`` keeps the plain loop
        (its steps go through the fused cell), as in the JAX package.  The
        kernels are float32 only: under a compute dtype no gap kernel runs
        (the JAX package's ``_pallas_on``)."""
        if not self._gap_eligible or self.compute_dtype is not None:
            return False
        if self.use_pallas is not True:
            return inference
        if self.debug_checks:
            return False
        return inference or gap_scan.gap_train_fits(self.hidden_dim)

    def _forced_route(self) -> Optional[str]:
        """What the forced kernels (``use_pallas=True``) carry of a training
        step, for the Trainer's "Training path:" line; None otherwise."""
        if self.use_pallas is not True:
            return None
        if self.grid_walk and self._use_walk_kernel():
            return "walk kernels"
        if self.dt_ode_step is not None and self._use_gap_scan():
            return "gap-loop kernels"
        if self._use_fused():
            return "fused Euler cell"
        return None

    def _use_fused_step(self, n_slots: int, n_batch: int = 0) -> bool:
        """Route ``apply`` through the fused-step kernels
        (``njode_tpu/models/jump_ode.py:238-268``, with the port's gates):
        under ``use_pallas="step"`` wherever the model is eligible
        (``fused_step_available``) and the shapes fit
        (``fused_step_fits``), CUDA tensors taking the kernels and CPU
        tensors their plain versions.  Under ``"auto"`` only at the shape
        where the H100 A/B of the scaled recipe had the kernels ahead of the
        composed path (PERF.md, section 6): on the card, separate networks,
        (hidden, ``n_slots``, layers, d_x, d_y, K) equal to
        ``AUTO_SHAPE_H100``, ``n_batch`` >= ``AUTO_MIN_BATCH_H100`` rows
        and the compute dtype in ``AUTO_COMPUTE_DTYPES_H100``.  The kernels
        compute float32 and bfloat16, not float16 (JAX ``:251``, ``:260``).
        Elsewhere the composed route."""
        if (not self._step_eligible
                or self.compute_dtype not in (None, torch.bfloat16)):
            return False
        if self.use_pallas == "auto":
            shape = (self.hidden_dim, n_slots, self.n_hidden_layers,
                     self.input_dim, self.output_dim, self.num_moments)
            if (self.device.type != "cuda" or self.shared_network
                    or self.compute_dtype
                    not in fused_step.AUTO_COMPUTE_DTYPES_H100
                    or shape != fused_step.AUTO_SHAPE_H100
                    or n_batch < fused_step.AUTO_MIN_BATCH_H100):
                return False
        elif self.use_pallas != "step":
            return False
        return fused_step.fused_step_fits(
            self.hidden_dim, n_slots, self.n_hidden_layers, self.input_dim,
            self.output_dim, self.num_moments)

    def _step_kwargs(self) -> dict:
        return dict(num_moments=self.num_moments, activation=self._act_key,
                    input_scaling=self._scale_key,
                    shared_network=self.shared_network,
                    input_dim=self.input_dim, output_dim=self.output_dim,
                    n_hidden_layers=self.n_hidden_layers,
                    compute_dtype=self.compute_dtype)

    def _net(self, net: nn.Module, x: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One network on x in the model's compute dtype (``_mp``,
        ``_mp_in``, ``_mp_out``), its output in x's dtype."""
        return run_net(net, x, generator, self.compute_dtype)

    def _jump(self, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, d_x) -> h: (K_h, B, d_h)."""
        if self.shared_network:
            return self._net(self.jump_nn, x, generator)[None]
        return torch.stack([self._net(net, x, generator)
                            for net in self.jump_nns])

    def _readout(self, h: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """h: (K_h, B, d_h) -> y: (B, d_y, K).

        Shared mode reshapes the flat (B, d_y*K) output row-major to
        (B, d_y, K), like the reference's ``.view(1, d_y, num_moments)``
        (reference models/jump_ode.py:170-172).
        """
        if self.shared_network:
            y = self._net(self.output_nn, h[0], generator)
            return y.reshape(y.shape[0], self.output_dim, self.num_moments)
        ys = torch.stack([self._net(net, hk, generator)
                          for net, hk in zip(self.output_nns, h)])
        return ys.permute(1, 2, 0)                         # (B, d_y, K)

    def variance_from_raw(self, raw: torch.Tensor) -> Optional[torch.Tensor]:
        """Conditional variance from raw moment outputs (..., d_y, K).

        ``direct``: Var = W^2; ``second_moment``: Var = E[X^2] - E[X]^2
        clipped at 0 (reference utils/plotting.py:183-200).  None for
        single-moment models.
        """
        if self.num_moments < 2:
            return None
        mean, w = raw[..., 0], raw[..., 1]
        if self.variance_method == "direct":
            return w ** 2
        return torch.clamp_min(w - mean ** 2, 0.0)

    def _ode(self, h: torch.Tensor, x_last: torch.Tensor,
             t_cur: torch.Tensor, t_new: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Latent drift dh/dt with the reference ODEFunc features
        [s(h), s(x_last), t_rel = t_cur, t_elapsed = t_new - t_cur].

        h: (K_h, B, d_h); x_last: (B, d_x); t_cur/t_new: (B,).
        """
        K_h, B, _ = h.shape
        x_s = self._scale(x_last)[None].expand(K_h, B, x_last.shape[-1])
        t_rel = t_cur[None, :, None].expand(K_h, B, 1).to(h.dtype)
        t_el = (t_new - t_cur)[None, :, None].expand(K_h, B, 1).to(h.dtype)
        # built in the carry's dtype, cast inside _net (JAX :432)
        inp = torch.cat([self._scale(h), x_s, t_rel, t_el], dim=-1)
        return torch.stack([self._net(f, ik, generator)
                            for f, ik in zip(self._ode_nets(), inp)])

    def _euler(self, h: torch.Tensor, x_last: torch.Tensor,
               t_cur: torch.Tensor, t_new: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One solver step from t_cur to t_new.

        'euler' is exactly the reference's ``h += (t_new - t_cur) * f``
        (reference :122-140).  'heun' and 'rk4' evaluate the drift at the
        stage time with ``t_elapsed = 0``, the ODE's ``t_elapsed -> 0``
        limit (see the JAX model's ``_euler``).
        """
        if (self.ode_solver == "euler" and generator is None
                and self._use_fused()):
            return fused_cell.ode_euler_fused(
                h, self._scale(x_last), self._scale(h), t_cur, t_new,
                self._ode_weights(), self._act_key)
        dt = (t_new - t_cur)[None, :, None]
        if self.ode_solver == "euler":
            return h + dt * self._ode(h, x_last, t_cur, t_new, generator)

        def f(hh, t_stage):
            return self._ode(hh, x_last, t_stage, t_stage, generator)
        if self.ode_solver == "heun":
            k1 = f(h, t_cur)
            k2 = f(h + dt * k1, t_new)
            return h + dt * 0.5 * (k1 + k2)
        t_mid = t_cur + 0.5 * (t_new - t_cur)
        k1 = f(h, t_cur)
        k2 = f(h + 0.5 * dt * k1, t_mid)
        k3 = f(h + 0.5 * dt * k2, t_mid)
        k4 = f(h + dt * k3, t_new)
        return h + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def _integrate_gap(self, h: torch.Tensor, x_last: torch.Tensor,
                       t_last: torch.Tensor, t_target: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       inference: bool = False) -> torch.Tensor:
        """Integrate the latent state across an inter-observation gap
        (reference forward_single, models/jump_ode.py:185-203).

        ``inference=True`` (no autograd, no dropout) lets an eligible
        ODEFunc take the gap kernel; a gap that autograd differentiates
        takes the plain loop, or under ``use_pallas=True`` the training
        pair (:meth:`_use_gap_scan`).

        The accumulated ``t_cur + dt`` float updates are kept (rather than a
        step count) so the boundary behaviour matches the reference's while
        loop bit for bit.
        """
        if self.dt_ode_step is None:
            return self._euler(h, x_last, t_last, t_target, generator)
        dt = self.dt_ode_step
        if generator is None and self._use_gap_scan(inference):
            weights = (self._gap_weights() if inference
                       else split_weights(self._ode_weights()))
            h, t_cur = integrate_gap_fused(
                h, self._scale(x_last), t_last, t_target, weights,
                dt, self.max_substeps, self._act_key, self._scale_key)
        else:
            t_cur = t_last
            for _ in range(self.max_substeps):
                pred = (t_cur + dt) < t_target
                t_new = t_cur + dt
                h_step = self._euler(h, x_last, t_cur, t_new, generator)
                h = torch.where(pred[None, :, None], h_step, h)
                t_cur = torch.where(pred, t_new, t_cur)
            h_final = self._euler(h, x_last, t_cur, t_target, generator)
            h = torch.where((t_cur < t_target)[None, :, None], h_final, h)
        if self.debug_checks and t_cur.numel():
            # every gap must be within one dt of its target after the full
            # steps; a larger remainder means the substep budget was too
            # small and the final 'partial' step silently spanned the rest
            deficit = float((t_target - t_cur).max())
            if deficit > dt * (1.0 + 1e-6):
                raise ValueError(
                    f"substep budget exhausted: a gap still had {deficit:.4g} "
                    f"left to integrate after max_substeps={self.max_substeps}"
                    f" full steps of dt_ode_step={dt}; construct the model "
                    "with t_max covering the largest observation gap (or "
                    "pass max_substeps explicitly).")
        return h

    def _integrate_gaps_grid(self, h_jump: torch.Tensor, times: torch.Tensor,
                             values: torch.Tensor,
                             mask: Optional[torch.Tensor],
                             generator: Optional[torch.Generator] = None,
                             inference: bool = False) -> torch.Tensor:
        """All inter-observation gaps as one time-major walk over the grid
        ``{g * dt_ode_step : g = 0..M}`` (``njode_tpu/models/jump_ode.py:
        540-644``): the carry (h, x_last, t_cur) of every row walks the M
        cells, emits its arriving (pre-jump) state and resets where an
        observation sits at the cell.  On an aligned grid a gap of k cells
        is k uniform solver steps, the per-gap loop's full steps plus its
        final partial step in exact arithmetic; the time features differ by
        about 1 ulp, so the two paths agree to f32 roundoff.

        The plain walk below keeps the XLA walk's features (``t_elapsed =
        t_new - t_cur``, euler, heun and rk4) and draws dropout from
        ``generator``; the kernel route (:meth:`_use_walk_kernel`, no
        generator) takes :func:`walk_gaps_fused`, whose t_elapsed is dt.

        h_jump: (K_h, B, N, d_h) after-jump states for all slots.
        Returns h_minus (K_h, B*S, d_h), the pre-jump state at slots 1..N-1.
        """
        dt = self.dt_ode_step
        M = self.max_substeps
        B, N = times.shape
        g_idx = torch.round(times / dt).to(torch.int64)          # (B, N)
        if self.debug_checks:
            off = (g_idx.to(times.dtype) * dt - times).abs()
            g_hi = g_idx
            if mask is not None:
                off = torch.where(mask, off, 0.0)
                g_hi = torch.where(mask, g_idx, 0)
            worst, top = float(off.max()), int(g_hi.max())
            _raise_on_grid_misalignment(
                worst > 1e-4 * max(dt, 1.0) or top > M, worst, dt)
        g_idx = g_idx.clamp(0, M)

        if generator is None and self._use_walk_kernel(inference):
            return walk_scan.walk_gaps_fused(
                h_jump, self._scale(values), times, mask, g_idx,
                self._ode_weights(), dt, M, self._act_key, self._scale_key)

        # a padded slot never resets the carry (its cell is never reached)
        reset = g_idx if mask is None else torch.where(mask, g_idx, -1)
        h_minus = walk_scan.walk_cells(
            h_jump, values, times, reset, g_idx, M, dt,
            lambda h, x, t: self._euler(h, x, t, t + dt, generator))
        return h_minus.reshape(h_jump.shape[0], B * (N - 1), self.hidden_dim)

    def _check_grid_alignment(self, times: torch.Tensor,
                              mask: Optional[torch.Tensor]) -> None:
        """The grid walk's guard (``njode_tpu/models/jump_ode.py:646-681``):
        every valid observation time sits on the grid, valid times are
        strictly increasing per row (one observation per cell), and none
        lies beyond the grid.  One host read for the three conditions."""
        m = torch.ones_like(times, dtype=torch.bool) if mask is None else mask
        dt = self.dt_ode_step
        off = torch.where(m, (torch.round(times / dt) * dt - times).abs(), 0.0)
        both = m[:, 1:] & m[:, :-1]
        gaps = torch.where(both, times[:, 1:] - times[:, :-1], torch.inf)
        worst, min_gap, t_hi = torch.stack([
            off.max(), gaps.min() if gaps.numel() else times.new_tensor(
                torch.inf), torch.where(m, times, 0.0).max()]).tolist()
        if worst > 1e-4 * max(dt, 1.0):
            raise ValueError(
                f"grid_walk=True but observation times are not multiples of "
                f"dt_ode_step={dt} (worst offset {worst:.3g}); disable "
                "grid_walk for off-grid data")
        if min_gap < dt * 0.5:
            raise ValueError(
                "grid_walk=True requires strictly increasing observation "
                "times (one observation per grid cell); found a duplicate "
                "or sub-dt gap")
        if t_hi > (self.max_substeps + 0.5) * dt:
            raise ValueError(
                f"grid_walk: an observation time exceeds the integration "
                f"grid (max_substeps={self.max_substeps} x dt_ode_step={dt}); "
                "construct the model with a larger t_max")

    def _check_gap_budget(self, gaps: torch.Tensor) -> None:
        """Raise if a concrete integration gap exceeds the substep budget
        (with fixed ``dt_ode_step`` it would be silently under-integrated)."""
        if self.dt_ode_step is None or gaps.numel() == 0:
            return
        max_gap = float(gaps.max())
        budget = (self.max_substeps + 1) * self.dt_ode_step
        if max_gap > budget + 1e-9:
            raise ValueError(
                f"integration gap {max_gap:.4g} exceeds the Euler substep "
                f"budget (max_substeps={self.max_substeps} x dt_ode_step="
                f"{self.dt_ode_step}); construct the model with "
                f"t_max >= {max_gap:.4g} (or pass max_substeps explicitly).")

    # ----------------------------------------------------- query inference

    def _query_rows(self, obs_times, obs_values, query_times, mask=None):
        """Flatten B x Q queries to rows: each query's latest observation
        with ``t_obs <= t`` (right-continuous filtration).

        Returns (x_last (B*Q, d_x), t_last (B*Q,), t_query (B*Q,),
        before_first (B, Q) bool).
        """
        obs_times = self._as_tensor(obs_times)
        obs_values = self._as_tensor(obs_values)
        query_times = self._as_tensor(query_times)
        B, N = obs_times.shape
        Q = query_times.shape[1]
        d_x = obs_values.shape[-1]
        if mask is not None:
            # exclude padded slots from the search by pushing them to +inf
            mask = self._as_tensor(mask, torch.bool)
            search_times = torch.where(mask, obs_times, torch.inf)
        else:
            search_times = obs_times
        idx = torch.searchsorted(search_times.contiguous(),
                                 query_times.contiguous(), right=True) - 1
        idx = idx.clamp(0, N - 1)                             # (B, Q)
        x_last = torch.gather(obs_values, 1, idx[..., None].expand(B, Q, d_x))
        t_last = torch.gather(obs_times, 1, idx)
        self._check_gap_budget(torch.clamp_min(query_times - t_last, 0.0))
        before_first = query_times < search_times[:, :1]
        return (x_last.reshape(B * Q, d_x), t_last.reshape(B * Q),
                query_times.reshape(B * Q), before_first)

    def predict_at(self, obs_times, obs_values, query_times, mask=None):
        """Conditional-moment predictions at arbitrary query times.

        Every query integrates independently from the state at its own last
        observation, so all B*Q queries run as one batch.  Queries before
        the first observation return 0, like the model's before-first
        prediction (reference models/jump_ode.py:161).

        Args:
          obs_times:  (B, N) sorted observation times (end-padded).
          obs_values: (B, N, d_x).
          query_times: (B, Q).
          mask: (B, N) observation validity.  Padding must repeat the last
            valid time/value (as :func:`pad_ragged` produces).

        Returns: dict with 'mean' (B, Q, d_y), 'var' (B, Q, d_y) or None,
          'raw' (B, Q, d_y, K).
        """
        with self._inference():
            x, t_last, t_query, before_first = self._query_rows(
                obs_times, obs_values, query_times, mask)
            B, Q = before_first.shape
            h = self._jump(x)                                 # (K_h, B*Q, d_h)
            h = self._integrate_gap(h, x, t_last, t_query, inference=True)
            raw = self._readout(h).reshape(B, Q, self.output_dim,
                                           self.num_moments)
            raw = torch.where(before_first[..., None, None], 0.0, raw)
            return {"mean": raw[..., 0], "var": self.variance_from_raw(raw),
                    "raw": raw}

    # -------------------------------------------------------- grid rollout

    def _grid_substeps(self, grid_times: torch.Tensor) -> int:
        """``n_sub = max(1, int(cell / dt_ode_step))`` of the first cell,
        in float64 of the grid already cast to the model's dtype
        (``njode_tpu/models/jump_ode.py:1007-1029``): at dt 0.001 on a
        float32 100-step grid it truncates to 9.  A non-uniform grid
        raises."""
        if self.dt_ode_step is None:
            return 1
        gt = grid_times.detach().to("cpu", torch.float64).numpy()
        G = gt.shape[0]
        if G > 2:
            gaps = np.diff(gt)
            if gaps.size and not np.allclose(gaps, gaps[0], rtol=1e-4,
                                             atol=1e-9):
                raise ValueError(
                    "predict_on_grid derives a single static substep "
                    "count from the first grid cell, which requires "
                    "uniform grid spacing; got non-uniform gaps "
                    f"(min {gaps.min():.3g}, max {gaps.max():.3g}). "
                    "Pass n_sub= explicitly (sized for the largest "
                    "cell) or use predict_at for irregular queries.")
        cell = float(gt[1] - gt[0]) if G > 1 else 0.0
        return max(1, int(cell / self.dt_ode_step))

    def predict_on_grid(self, grid_times, obs_mask, path_values,
                        n_sub: Optional[int] = None):
        """Dense-grid inference with the reference's plotting semantics
        (``njode_tpu/models/jump_ode.py:977-1071``): each grid cell takes
        ``n_sub`` equal ``_euler`` substeps from the last observation's
        value, the state jumps at an observed grid point and the readout is
        the after-jump one, state and output stay zero until the first
        observation, and the rollout extrapolates past the last one.

        Args:
          grid_times:  (G,) the dense time grid (uniform spacing for the
                       derived substep count).
          obs_mask:    (B, G) True where the grid point is observed.
          path_values: (B, G, d_x) path values on the grid (read only at
                       observed points).
          n_sub:       substeps a grid cell; default from ``dt_ode_step``
                       and the first cell (:meth:`_grid_substeps`).

        Returns: dict with 'mean' (B, G, d_y), 'var' (B, G, d_y) or None,
          and 'raw' (B, G, d_y, K).
        """
        with self._inference():
            grid_times = self._as_tensor(grid_times)
            path_values = self._as_tensor(path_values)
            obs_mask = self._as_tensor(obs_mask, torch.bool)
            B, G = obs_mask.shape
            if n_sub is None:
                n_sub = self._grid_substeps(grid_times)
            h = torch.zeros(self.k_hidden, B, self.hidden_dim,
                            dtype=self.dtype, device=self.device)
            x_last = torch.zeros(B, self.input_dim, dtype=self.dtype,
                                 device=self.device)
            t_cur = grid_times[0].expand(B)
            seen = torch.zeros(B, dtype=torch.bool, device=self.device)
            ys = []
            for k in range(G):
                t_k = grid_times[k].expand(B)
                dt_sub = (t_k - t_cur) / float(n_sub)
                h_int, t_c = h, t_cur
                for _ in range(n_sub):
                    t_n = t_c + dt_sub
                    h_int = self._euler(h_int, x_last, t_c, t_n)
                    t_c = t_n
                m_k = obs_mask[:, k]
                x_k = path_values[:, k]
                h = torch.where(m_k[None, :, None], self._jump(x_k),
                                torch.where(seen[None, :, None], h_int, h))
                x_last = torch.where(m_k[:, None], x_k, x_last)
                seen = seen | m_k
                y = self._readout(h)                          # (B, d_y, K)
                ys.append(torch.where(seen[:, None, None], y, 0.0))
                t_cur = t_k
            raw = torch.stack(ys, dim=1)                      # (B, G, d_y, K)
            return {"mean": raw[..., 0], "var": self.variance_from_raw(raw),
                    "raw": raw}

    # ------------------------------------------------------------ training

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _check_substep_budget(self, times: torch.Tensor) -> None:
        """Raise if an observation gap needs more full substeps than the
        static budget (with fixed ``dt_ode_step`` the final partial step
        would silently span the rest).  Reads the gaps on the host."""
        if self.dt_ode_step is None or times.ndim != 2 or times.shape[1] < 2:
            return
        max_gap = float((times[:, 1:] - times[:, :-1]).max())
        budget = (self.max_substeps + 1) * self.dt_ode_step
        if max_gap > budget + 1e-9:
            raise ValueError(
                f"observation gap {max_gap:.4g} exceeds the Euler substep "
                f"budget (max_substeps={self.max_substeps} x dt_ode_step="
                f"{self.dt_ode_step}); construct the model with "
                f"t_max >= {max_gap:.4g} (or pass max_substeps explicitly).")

    def apply(self, times, values, mask=None, *,
              generator: Optional[torch.Generator] = None,
              training: bool = False):
        """Batched forward over padded observation slots.

        The jump resets the latent state at every observation (reference
        models/jump_ode.py:169,176), so every gap integrates independently
        from its own jump state and the whole forward is batched over the
        folded (B*N) slots:

          h_jump[:, i]  = jump(x_i)               for all slots at once
          y_after[:, i] = out(h_jump[:, i])
          h_minus[:, i] = integrate(h_jump[:, i-1], x_{i-1}, t_{i-1} -> t_i)
          y_before[:,i] = out(h_minus[:, i]),  y_before[:, 0] = 0.

        Args:
          times:  (B, N) observation times, sorted per row, padded at the end.
          values: (B, N, d_x) observations.
          mask:   (B, N) validity; padding must sit at row ends (padded
                  slots carry garbage the loss masks out; the grid walk
                  keeps them from resetting its carry).
          generator: dropout generator, read only when ``training`` and
                  ``dropout_rate > 0``.

        Returns: preds, preds_before, each (B, N, d_y, K).
        """
        times = self._as_tensor(times)
        values = self._as_tensor(values)
        self._check_substep_budget(times)
        gen = (generator if training and self.dropout_rate > 0.0 else None)
        B, N = times.shape
        # (the fused step is ineligible with dropout, so no generator here)
        if self._use_fused_step(N, B):
            return fused_step.fused_step_apply(self, times, values)
        d_x = values.shape[-1]
        K_h, d_h = self.k_hidden, self.hidden_dim

        h_jump = self._jump(values.reshape(B * N, d_x), gen)  # (K_h, B*N, d_h)
        preds = self._readout(h_jump, gen).reshape(
            B, N, self.output_dim, self.num_moments)
        if N == 1:
            return preds, torch.zeros_like(preds)

        S = N - 1
        inference = gen is None and not torch.is_grad_enabled()
        # grid_walk is permission to walk; under "auto" the walk is taken
        # only where its kernels carry it, as in the JAX package
        # (njode_tpu/models/jump_ode.py:806-820), and under True too, whose
        # walk the JAX package runs on the walk kernel on its TPU (a no-grad
        # walk on the card takes the per-gap route, as under "auto")
        use_walk = self.grid_walk
        if use_walk and self.use_pallas in ("auto", True):
            use_walk = self._use_walk_kernel(inference)
        if use_walk:
            if mask is not None:
                mask = self._as_tensor(mask, torch.bool)
            self._check_grid_alignment(times, mask)
            h_minus = self._integrate_gaps_grid(
                h_jump.reshape(K_h, B, N, d_h), times, values, mask, gen,
                inference)
        else:
            h0 = h_jump.reshape(K_h, B, N, d_h)[:, :, :-1].reshape(
                K_h, B * S, d_h)
            h_minus = self._integrate_gap(
                h0, values[:, :-1].reshape(B * S, d_x),
                times[:, :-1].reshape(B * S), times[:, 1:].reshape(B * S),
                gen, inference=inference)
        tail = self._readout(h_minus, gen).reshape(
            B, S, self.output_dim, self.num_moments)
        # the prediction before the first observation is zero
        # (reference models/jump_ode.py:161)
        preds_before = torch.cat([torch.zeros_like(preds[:, :1]), tail], dim=1)
        return preds, preds_before

    def apply_loss(self, times, values, mask=None, *,
                   generator: Optional[torch.Generator] = None,
                   training: bool = False,
                   ignore_first_continuity: bool = False,
                   moment_weights=None, eps: float = 1e-10,
                   variance_method: str = "direct", traj_mask=None,
                   extended_moments: bool = False) -> torch.Tensor:
        """``nj_ode_loss_dense(values, *self.apply(...), mask, ...)``; where
        ``apply`` takes the fused step, so does the loss's forward."""
        values = self._as_tensor(values)
        preds, preds_before = self.apply(times, values, mask,
                                         generator=generator,
                                         training=training)
        if mask is not None:
            mask = self._as_tensor(mask, torch.bool)
        if traj_mask is not None:
            traj_mask = self._as_tensor(traj_mask, torch.bool)
        return nj_ode_loss_dense(
            values, preds, preds_before, mask,
            ignore_first_continuity=ignore_first_continuity,
            moment_weights=moment_weights, eps=eps,
            variance_method=variance_method, traj_mask=traj_mask,
            extended_moments=extended_moments)

    def forward(self, batch_times: Sequence, batch_values: Sequence,
                generator: Optional[torch.Generator] = None,
                training: bool = False):
        """Reference-compatible ragged forward (models/jump_ode.py:218-233):
        lists of (n_i,) times and (n_i, d_x) values in, lists of
        (n_i, d_y, K) after- and before-jump predictions out."""
        times, values, mask = pad_ragged(batch_times, batch_values,
                                         self.dtype, self.device)
        preds, preds_before = self.apply(times, values, mask,
                                         generator=generator,
                                         training=training)
        lengths = [int(torch.as_tensor(t).reshape(-1).shape[0])
                   for t in batch_times]
        return ([preds[b, :n] for b, n in enumerate(lengths)],
                [preds_before[b, :n] for b, n in enumerate(lengths)])



def pad_ragged(batch_times: Sequence, batch_values: Sequence,
               dtype: torch.dtype = torch.float32, device=None):
    """Pad ragged per-trajectory (times, values) lists to dense tensors.

    Padding repeats the last valid time/value (keeps gaps non-negative) and
    is always at the row end.  Returns (times (B, N), values (B, N, d_x),
    mask (B, N) bool).
    """
    rows_t = [torch.as_tensor(t, dtype=torch.float32).reshape(-1)
              for t in batch_times]
    lengths = [t.shape[0] for t in rows_t]
    d_x = torch.as_tensor(batch_values[0]).reshape(lengths[0], -1).shape[-1]
    rows_v = [torch.as_tensor(v, dtype=torch.float32).reshape(n, d_x)
              for v, n in zip(batch_values, lengths)]
    B, N = len(rows_t), max(lengths)
    times = torch.zeros(B, N)
    values = torch.zeros(B, N, d_x)
    mask = torch.zeros(B, N, dtype=torch.bool)
    for b, (t, v, n) in enumerate(zip(rows_t, rows_v, lengths)):
        times[b, :n], values[b, :n], mask[b, :n] = t, v, True
        times[b, n:], values[b, n:] = t[-1], v[-1]
    return (times.to(device=device, dtype=dtype),
            values.to(device=device, dtype=dtype), mask.to(device=device))
