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
training to XLA (``njode_tpu/models/jump_ode.py:301-310``); the kernel has
no backward yet.

Training: :meth:`NeuralJumpODE.apply` is the dense slot-batched forward
(jump at every slot, one integration per gap, readouts), ``apply_loss``
composes it with :func:`nj_ode_loss_dense`, and ``forward`` is the ragged
reference API.  Dropout in training mode draws from an explicit
``torch.Generator``; without one no dropout is applied, as the JAX model
applies none without an rng.

The model's device defaults to ``cuda``; the CPU is used only when asked
for (``device="cpu"``).  Without a CUDA device the default raises.

Not ported yet (see ROADMAP.md): ``predict_on_grid``, the grid walk, mixed
precision and the fused-step kernel; the constructor arguments that select
them raise.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import (GapWeights, gap_scan_available, integrate_gap_fused,
                   split_weights)
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


def run_net(net: nn.Module, x: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A network's layers in order, with inverted dropout (torch's
    train-mode law) drawn from ``generator`` where one is given, and no
    dropout otherwise, whatever the module's train/eval mode."""
    for layer in net.net:
        if isinstance(layer, nn.Dropout):
            if generator is not None and layer.p > 0.0:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) >= layer.p
                x = torch.where(keep, x / (1.0 - layer.p), 0.0)
        else:
            x = layer(x)
    return x


class NeuralJumpODE(nn.Module):
    """Neural Jump ODE with the JAX model's constructor signature.

    Port-specific arguments:
      device:    where the parameters live: None (default) means ``cuda``
                 and raises without a CUDA device; pass ``"cpu"`` for the
                 CPU (see :func:`resolve_device`).
      generator: the ``torch.Generator`` the init draws from; None means a
                 CPU generator seeded with 0.  Weights are drawn on the CPU
                 and then moved, so a seed gives the same model everywhere.
      use_pallas: "auto" (default) or False, kept for the JAX signature:
                 the port has one path per configuration (the CUDA kernel
                 wherever it applies), so neither changes what runs.  True,
                 "interpret" and "step" select JAX kernels that are not
                 ported yet and raise.
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
        if grid_walk:
            raise NotImplementedError(
                "grid_walk=True: the grid walk and its kernel are not ported "
                "yet (ROADMAP.md, Queue 1 item 9 and Queue 2 walk_scan)")
        if compute_dtype is not None:
            raise NotImplementedError(
                "compute_dtype: mixed precision is not ported yet "
                "(ROADMAP.md, Queue 2 fused_step)")
        if use_pallas in ("step", "step-interpret"):
            raise NotImplementedError(
                "use_pallas='step': the fused training-step kernel is not "
                "ported yet (ROADMAP.md, Queue 2 fused_step)")
        if use_pallas is True or use_pallas == "interpret":
            raise NotImplementedError(
                f"use_pallas={use_pallas!r} selects the per-substep fused "
                "Euler cell kernel, which is not ported yet (ROADMAP.md, "
                "Queue 2 fused_cell)")
        if use_pallas not in ("auto", False):
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
        self.dtype = dtype
        self.ode_solver = ode_solver
        self.debug_checks = debug_checks

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
        K_h.  Cut once and kept until a parameter moves (``.to``) or
        changes in place (``load_state_dict``, an optimizer step), which
        bumps its version; writes through ``.data`` bypass that count."""
        params = [p for l1, l2 in map(linears, self._ode_nets())
                  for p in (l1.weight, l1.bias, l2.weight, l2.bias)]
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._gap_cache is None or self._gap_cache[0] != key:
            # (W1, b1, W2, b2), each stacked on K_h
            stacked = [torch.stack(params[i::4]) for i in range(4)]
            self._gap_cache = (key, split_weights(stacked))
        return self._gap_cache[1]

    def _jump(self, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, d_x) -> h: (K_h, B, d_h)."""
        if self.shared_network:
            return run_net(self.jump_nn, x, generator)[None]
        return torch.stack([run_net(net, x, generator)
                            for net in self.jump_nns])

    def _readout(self, h: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """h: (K_h, B, d_h) -> y: (B, d_y, K).

        Shared mode reshapes the flat (B, d_y*K) output row-major to
        (B, d_y, K), like the reference's ``.view(1, d_y, num_moments)``
        (reference models/jump_ode.py:170-172).
        """
        if self.shared_network:
            y = run_net(self.output_nn, h[0], generator)
            return y.reshape(y.shape[0], self.output_dim, self.num_moments)
        ys = torch.stack([run_net(net, hk, generator)
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
        inp = torch.cat([self._scale(h), x_s, t_rel, t_el], dim=-1)
        return torch.stack([run_net(f, ik, generator)
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
        takes the plain loop (the kernel has no backward yet).

        The accumulated ``t_cur + dt`` float updates are kept (rather than a
        step count) so the boundary behaviour matches the reference's while
        loop bit for bit.
        """
        if self.dt_ode_step is None:
            return self._euler(h, x_last, t_last, t_target, generator)
        dt = self.dt_ode_step
        if self._gap_eligible and inference and generator is None:
            h, t_cur = integrate_gap_fused(
                h, self._scale(x_last), t_last, t_target, self._gap_weights(),
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
          mask:   (B, N) validity; padding must sit at row ends (unused
                  here: padded slots carry garbage the loss masks out).
          generator: dropout generator, read only when ``training`` and
                  ``dropout_rate > 0``.

        Returns: preds, preds_before, each (B, N, d_y, K).
        """
        times = self._as_tensor(times)
        values = self._as_tensor(values)
        self._check_substep_budget(times)
        gen = (generator if training and self.dropout_rate > 0.0 else None)
        B, N = times.shape
        d_x = values.shape[-1]
        K_h, d_h = self.k_hidden, self.hidden_dim

        h_jump = self._jump(values.reshape(B * N, d_x), gen)  # (K_h, B*N, d_h)
        preds = self._readout(h_jump, gen).reshape(
            B, N, self.output_dim, self.num_moments)
        if N == 1:
            return preds, torch.zeros_like(preds)

        S = N - 1
        h0 = h_jump.reshape(K_h, B, N, d_h)[:, :, :-1].reshape(K_h, B * S, d_h)
        h_minus = self._integrate_gap(
            h0, values[:, :-1].reshape(B * S, d_x),
            times[:, :-1].reshape(B * S), times[:, 1:].reshape(B * S), gen,
            inference=gen is None and not torch.is_grad_enabled())
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
        """``nj_ode_loss_dense(values, *self.apply(...), mask, ...)``: the
        composed branch of the JAX ``apply_loss`` (its fused-step branch is
        not ported; ``use_pallas='step'`` raises at construction)."""
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
