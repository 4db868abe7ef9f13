"""The time-major grid walk: all gaps of a batch in one pass over the grid.

Port of ``njode_tpu/ops/walk_scan.py``.  With ``grid_walk`` every
observation time sits on the integration grid ``{g * dt_ode_step}``, so one
walk over the M grid cells, carrying (h, t, x) per row and resetting it at
each observation cell, integrates every gap of every row (the model's
``_integrate_gaps_grid``).  The composed grid-walk training step runs it
under autograd; a walk without autograd on the card takes the per-gap
route instead (the model's ``_use_walk_kernel``).

Kernels: ``csrc/walk_scan.cu``, ``njode_walk_fwd`` (replaces the TPU kernel
``walk_scan.py:148`` ``_fwd_kernel``) and ``njode_walk_bwd`` (replaces
``:226`` ``_bwd_kernel``), joined by :class:`WalkScan`, a
``torch.autograd.Function``.  The TPU lane layout (``[h, t, x, 1]`` in 128
lanes, row pairs, per-cell DMA streams) is not copied: the kernels take
logical shapes.  See the source for the design.

Semantics, as the JAX kernel's (``walk_scan.py:467-559``): the walk's
t_elapsed feature is the constant dt, folded into the cell-invariant bias
``cvec = dt * w1_tel + b1``; a padded slot never resets the carry; a slot
at cell M (t = T) reads the final carry.  The model's plain walk (XLA
semantics, ``t_elapsed = t_new - t_cur``) lives in ``models/jump_ode.py``;
the two agree to f32 roundoff.

Weights come in torch's orientation, stacked on K_h: W1 (K_h, d_h, d_h+3)
with input columns [s(h), x, t_rel, t_elapsed], b1 (K_h, d_h), W2 (K_h,
d_h, d_h), b2 (K_h, d_h).

Wrappers: :func:`walk_gaps_fused` launches the kernels for CUDA tensors and
takes :func:`walk_gaps_reference` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from .activations import _ACT, _SCALE, SCALINGS, SUPPORTED_ACTS

# launches of the forward and backward kernels in this process; callers may
# reset them to 0
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
# the kernels' widest hidden size (4 columns per lane)
MAX_HIDDEN = 128


def walk_scan_available(n_hidden_layers: int, activation: str,
                        dropout_rate: float, input_scaling: str,
                        input_dim: int, hidden_dim: int) -> bool:
    """Whether the kernels compute this ODEFunc (canonical names expected);
    the grid-alignment promise is the caller's."""
    return (n_hidden_layers == 1 and dropout_rate == 0.0
            and activation in SUPPORTED_ACTS and input_scaling in _SCALE
            and input_dim == 1 and 1 <= hidden_dim <= MAX_HIDDEN)


def split_walk_weights(weights: Sequence[torch.Tensor], dt: float):
    """The logical split of the ODEFunc weights (counterpart of the JAX
    ``_weight_blocks``, without its lane layout): W1's rows in (in, out)
    orientation, [h (d_h rows), x, t_rel, t_elapsed], and the cell-invariant
    bias cvec = dt * w1_tel + b1.  Returns (w1_io (K, d_h+3, d_h), cvec,
    w2_io (K, d_h, d_h), b2), differentiable."""
    w1, b1, w2, b2 = weights
    if w1.shape[-1] != w2.shape[-1] + 3:
        raise ValueError(f"walk: ODEFunc W1 {tuple(w1.shape)} needs d_h + 3 "
                         "inputs (one input dimension)")
    w1_io = w1.transpose(1, 2)
    return w1_io, float(dt) * w1_io[:, -1] + b1, w2.transpose(1, 2), b2


def slot_cells(mask: Optional[torch.Tensor], g_idx: torch.Tensor,
               n_cells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(reset cell, read cell) of every slot, int32 (B, N): the read cell is
    clip(g, 0, M); the reset cell is the same for a valid slot and -1 (never
    reached) for a padded one."""
    read = torch.clamp(g_idx.to(torch.int32), 0, int(n_cells))
    reset = read if mask is None else torch.where(mask.bool(), read, -1)
    return reset.to(torch.int32).contiguous(), read.contiguous()


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def walk_cells(h_jump, xs, times, reset, read, n_cells: int, dt: float,
               step):
    """The time-major walk of every plain version (this module's, the
    model's XLA-semantics walk, the walk-train reference): the carry (h, x,
    t) of every row walks cells 0..M-1; at cell g a slot s with
    ``reset[b, s] == g`` (-1: never) resets it to (h_jump[:, b, s],
    xs[b, s], times[b, s]); then ``step(h, x, t)`` (h (K, B, d), x (B, d_x),
    t (B,) the cell's start) takes the cell and t advances by dt.

    Returns the arrival read at cell ``read[:, 1:]`` (in [0, M]; M is the
    final carry): (K, B, N-1, d), the pre-jump states at slots 1..N-1."""
    B = times.shape[0]
    rows = torch.arange(B, device=times.device)
    h = torch.zeros_like(h_jump[:, :, 0])
    x = torch.zeros_like(xs[:, 0])
    t = torch.zeros_like(times[:, 0])
    arrivals = []
    for g in range(int(n_cells)):
        arrivals.append(h)
        sel = reset == g                                   # (B, N)
        has = sel.any(1)
        s = sel.to(torch.int64).argmax(1)
        h = torch.where(has[None, :, None], h_jump[:, rows, s], h)
        x = torch.where(has[:, None], xs[rows, s], x)
        t = torch.where(has, times[rows, s], t)
        h = step(h, x, t)
        t = t + dt
    arrivals.append(h)
    arr = torch.stack(arrivals, 1)                         # (K, M+1, B, d)
    return arr[:, read[:, 1:].long(), rows[:, None]]


def walk_gaps_reference(h_jump, x_scaled, times, mask, g_idx,
                        weights: Sequence[torch.Tensor], dt_ode_step: float,
                        n_cells: int, act_name: str, scale_name: str):
    """Plain PyTorch version of the kernels, on any device and
    differentiable: the walk cell by cell with the kernel's arithmetic
    (t_elapsed = dt inside cvec).  Same arguments and result as
    :func:`walk_gaps_fused`."""
    act, scale = _ACT[act_name], _SCALE[scale_name]
    K, B, N, d = h_jump.shape
    M, dt = int(n_cells), float(dt_ode_step)
    w1_io, cvec, w2_io, b2 = split_walk_weights(weights, dt)
    w1h, w1x, w1t = w1_io[:, :d], w1_io[:, d], w1_io[:, d + 1]

    def euler(h, x, t):
        pre = (torch.matmul(scale(h), w1h) + x[None] * w1x[:, None]
               + t[None, :, None] * w1t[:, None] + cvec[:, None])
        return h + dt * (torch.matmul(act(pre), w2_io) + b2[:, None])

    reset, read = slot_cells(mask, g_idx, M)
    h_minus = walk_cells(h_jump, x_scaled, times, reset, read, M, dt, euler)
    return h_minus.reshape(K, B * (N - 1), d)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

@functools.cache
def _load_kernel():
    """Build (first call only) and bind ``njode_walk_fwd``/``_bwd``."""
    from ._build import load
    lib = load("walk_scan")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.njode_walk_fwd.argtypes = [P] * 13 + [I] * 5 + [F] + [I] * 2 + [P]
    lib.njode_walk_fwd.restype = I
    lib.njode_walk_bwd.argtypes = [P] * 12 + [I] * 5 + [F] + [I] * 2 + [P]
    lib.njode_walk_bwd.restype = I
    lib.njode_walk_partial_floats.argtypes = [I] * 3
    lib.njode_walk_partial_floats.restype = ctypes.c_longlong
    return lib


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


class WalkScan(torch.autograd.Function):
    """The kernel pair as one differentiable op: (h_jump, W1, b1, W2, b2) ->
    h_minus (K, B, N-1, d).  The backward returns the cotangents of h_jump
    and the four weights (W1's t_elapsed row gets dt times the cotangent of
    cvec, b1 that cotangent); x, times and the cells get none."""

    @staticmethod
    def forward(ctx, h_jump, w1, b1, w2, b2, xs, ts, reset, read, dt, M,
                act_name, scale_name):
        global LAUNCHES_FWD
        K, B, N, d = h_jump.shape
        w1_io, cvec, w2_io, _ = split_walk_weights((w1, b1, w2, b2), dt)
        w1_io, cvec, w2_io = (w1_io.contiguous(), cvec.contiguous(),
                              w2_io.contiguous())
        b2c, hj = b2.contiguous(), h_jump.contiguous()
        save = any(ctx.needs_input_grad[:5])
        dev = h_jump.device
        h_minus = torch.empty(K, B, N - 1, d, dtype=torch.float32, device=dev)
        res = ((torch.empty(K, M, B, d, dtype=torch.float32, device=dev),
                torch.empty(M, B, dtype=torch.float32, device=dev),
                torch.empty(M, B, dtype=torch.float32, device=dev))
               if save else (None, None, None))
        lib = _load_kernel()
        with torch.cuda.device(dev):
            err = lib.njode_walk_fwd(
                hj.data_ptr(), xs.data_ptr(), ts.data_ptr(), reset.data_ptr(),
                read.data_ptr(), w1_io.data_ptr(), cvec.data_ptr(),
                w2_io.data_ptr(), b2c.data_ptr(), h_minus.data_ptr(),
                *(_ptr(r) for r in res), K, B, N, d, M, float(dt),
                SUPPORTED_ACTS.index(act_name), SCALINGS.index(scale_name),
                _stream(dev))
        from ._build import check
        check(lib, err, "njode_walk_fwd launch")
        LAUNCHES_FWD += 1
        if save:
            ctx.save_for_backward(w1_io, cvec, w2_io, reset, read, *res)
            ctx.meta = (K, B, N, d, M, float(dt), act_name, scale_name)
        return h_minus

    @staticmethod
    def backward(ctx, ct_hm):
        global LAUNCHES_BWD
        w1_io, cvec, w2_io, reset, read, res_h, res_t, res_x = ctx.saved_tensors
        K, B, N, d, M, dt, act_name, scale_name = ctx.meta
        dev = ct_hm.device
        ct_hm = ct_hm.contiguous()
        ct_hj = torch.zeros(K, B, N, d, dtype=torch.float32, device=dev)
        lib = _load_kernel()
        partial = torch.empty(int(lib.njode_walk_partial_floats(K, B, d)),
                              dtype=torch.float32, device=dev)
        grads = torch.empty(K, 2 * d * d + 4 * d, dtype=torch.float32,
                            device=dev)
        with torch.cuda.device(dev):
            err = lib.njode_walk_bwd(
                ct_hm.data_ptr(), res_h.data_ptr(), res_t.data_ptr(),
                res_x.data_ptr(), reset.data_ptr(), read.data_ptr(),
                w1_io.data_ptr(), cvec.data_ptr(), w2_io.data_ptr(),
                ct_hj.data_ptr(), partial.data_ptr(), grads.data_ptr(),
                K, B, N, d, M, dt, SUPPORTED_ACTS.index(act_name),
                SCALINGS.index(scale_name), _stream(dev))
        from ._build import check
        check(lib, err, "njode_walk_bwd launch")
        LAUNCHES_BWD += 1
        dd = d * d
        d_w1h = grads[:, :dd].reshape(K, d, d)
        d_w2 = grads[:, dd:2 * dd].reshape(K, d, d)
        d_w1x, d_w1t, d_cvec, d_b2 = grads[:, 2 * dd:].reshape(K, 4, d).unbind(1)
        d_w1 = torch.cat([d_w1h, d_w1x[:, None], d_w1t[:, None],
                          (dt * d_cvec)[:, None]], dim=1)     # (in, out)
        return (ct_hj, d_w1.transpose(1, 2), d_cvec, d_w2.transpose(1, 2),
                d_b2, None, None, None, None, None, None, None, None)


def walk_gaps_fused(h_jump, x_scaled, times, mask, g_idx,
                    weights: Sequence[torch.Tensor], dt_ode_step: float,
                    n_cells: int, act_name: str, scale_name: str):
    """The grid walk for all K_h moment networks: the CUDA kernels for CUDA
    tensors (differentiable through :class:`WalkScan`), the plain version
    for CPU tensors, an error otherwise.

    Args:
      h_jump:   (K_h, B, N, d_h) after-jump states at every slot.
      x_scaled: (B, N, 1) input-scaled observations (d_x == 1).
      times:    (B, N) observation times.
      mask:     (B, N) slot validity or None.
      g_idx:    (B, N) integer grid cell of each slot.
      weights:  (W1, b1, W2, b2) stacked on K_h, torch orientation.
      n_cells:  M, the number of dt-cells covering [0, t_max].

    Returns: (K_h, B*(N-1), d_h) pre-jump states at slots 1..N-1.
    """
    tensors = [h_jump, x_scaled, times, g_idx, *weights] + (
        [] if mask is None else [mask])
    if all(x.device.type == "cpu" for x in tensors):
        return walk_gaps_reference(h_jump, x_scaled, times, mask, g_idx,
                                   weights, dt_ode_step, n_cells, act_name,
                                   scale_name)
    dev = h_jump.device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"walk_gaps_fused: no kernel for device {dev} (or "
                         "tensors on mixed devices)")
    if act_name not in SUPPORTED_ACTS or scale_name not in _SCALE:
        raise ValueError(f"walk_gaps_fused: unsupported activation/scaling "
                         f"{act_name!r}/{scale_name!r}")
    K, B, N, d = h_jump.shape
    if not 1 <= d <= MAX_HIDDEN or N < 2 or x_scaled.shape != (B, N, 1):
        raise ValueError(f"walk_gaps_fused: h_jump {tuple(h_jump.shape)} and "
                         f"x {tuple(x_scaled.shape)} need 1 <= d_h <= "
                         f"{MAX_HIDDEN}, N >= 2 and one input dimension")
    if any(x.dtype != torch.float32 for x in [h_jump, x_scaled, times,
                                              *weights]):
        raise TypeError("walk_gaps_fused: the CUDA kernels take float32")
    if not float(dt_ode_step) > 0.0 or int(n_cells) < 0:
        raise ValueError("walk_gaps_fused: need dt_ode_step > 0, n_cells >= 0")
    reset, read = slot_cells(mask, g_idx, n_cells)
    h_minus = WalkScan.apply(
        h_jump, *weights, x_scaled[..., 0].contiguous(), times.contiguous(),
        reset, read, float(dt_ode_step), int(n_cells), act_name, scale_name)
    return h_minus.reshape(K, B * (N - 1), d)
