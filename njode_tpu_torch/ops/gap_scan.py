"""Whole-gap Euler integration: the substep loop as one CUDA kernel.

Port of ``njode_tpu/ops/gap_scan.py``.  With ``dt_ode_step`` set (the
production recipes: 0.01), every inter-observation gap integrates with up to
``max_substeps`` predicated Euler substeps, then one final partial step to
exactly the target time (reference models/jump_ode.py:196-202).  The
serving path (``predict_at``, ``NJODEFilter.predict``) runs this for every
query row.

Kernel: ``csrc/gap_scan.cu`` (``njode_gap_scan_fwd``), which replaces the
TPU kernel ``njode_tpu/ops/gap_scan.py:_fwd_kernel_lean`` (primal only, no
residuals).  It runs the whole full-step loop per row tile on chip; the
hoisted ``base`` and the final partial step stay in PyTorch around it, as the
JAX package leaves them to XLA.  On the H100 the loop is bound by the two
(d_h x d_h) f32 products per substep (4 d_h^2 flops per row and substep);
device memory is touched once per gap.  The design keeps h, the hidden
activations and ``base`` in shared memory and t in registers for the whole
loop, stages the weights in shared memory when they fit, shares each weight
load across 4 rows, and lets each warp leave the loop once none of its rows
still moves, so a batch of short gaps pays for few substeps.  See the source
for the layout.

Feature split (exact algebra of the ODEFunc concat, reference
models/jump_ode.py:52-63; W1 rows are [h, x, t_rel, t_elapsed]):

    pre = [s(h), s(x), t, dt] W1 + b1
        = s(h) W1h  +  t w1t  +  (s(x) W1x + dt w1dt + b1)    # = base

The full steps use the constant ``dt`` as the t_elapsed feature, like the
JAX kernel.  The non-kernel loop of the model uses ``t_new - t_cur``; the two
differ by rounding.  t advances by single f32 adds with the predicate
``(t + dt) < t_target``, so t_L is bitwise the same in the kernel, its plain
version and the JAX kernel.

Weights: :func:`split_weights` cuts the stacked ODEFunc weights once into
:class:`GapWeights`, W1 split by feature rows and both matrices turned to the
(in, out) orientation the kernel reads; the model keeps the result until its
parameters change, so a call copies no weights.

Wrappers: :func:`gap_substeps` launches the kernel for CUDA tensors and takes
its plain version :func:`gap_substeps_reference` only for CPU tensors;
:func:`integrate_gap_fused` is the model-facing whole-gap function and
:func:`integrate_gap_reference` its plain version.  Only the forward exists:
the backward kernels (JAX ``_bwd_kernel``/``_bwd_kernel_ck`` and the
residual forwards) are not ported, so a call that autograd would have to
differentiate raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

# the kernel's activation / scaling codes are positions in these tuples
from .activations import _ACT, _SCALE, SCALINGS, SUPPORTED_ACTS

# launches of the CUDA kernel in this process; callers may reset it to 0
LAUNCHES = 0


def gap_scan_available(n_hidden_layers: int, activation: str,
                       dropout_rate: float, input_scaling: str) -> bool:
    """Whether the kernel computes this ODEFunc (canonical names expected)."""
    return (n_hidden_layers == 1 and dropout_rate == 0.0
            and activation in SUPPORTED_ACTS and input_scaling in _SCALE)


# --------------------------------------------------------------------------
# the full-step loop: kernel and plain version
# --------------------------------------------------------------------------

def gap_substeps_reference(h, base, t_last, t_target, w1h, w1t, w2, b2,
                           dt: float, n_sub: int, act_name: str,
                           scale_name: str):
    """Plain PyTorch version of the kernel: the full predicated substeps.

    h, base: (K, R, d_h); t_last, t_target: (R,); w1h, w2: (K, d_h, d_h) in
    (in, out) orientation, as :class:`GapWeights` holds them; w1t, b2:
    (K, d_h).  Returns (h_L, t_L).
    """
    act, scale = _ACT[act_name], _SCALE[scale_name]
    w1t_row, b2_row = w1t[:, None, :], b2[:, None, :]
    t = t_last
    for _ in range(n_sub):
        pred = (t + dt) < t_target
        pre = torch.matmul(scale(h), w1h) + base + t[None, :, None] * w1t_row
        dh = torch.matmul(act(pre), w2) + b2_row
        h = torch.where(pred[None, :, None], h + dt * dh, h)
        t = torch.where(pred, t + dt, t)
    return h, t


@functools.cache
def _load_kernel():
    """Build (first call only) and bind ``njode_gap_scan_fwd``."""
    from ._build import load
    lib = load("gap_scan")
    fn = lib.njode_gap_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check_cuda_inputs(named: dict[str, torch.Tensor],
                       shapes: dict[str, tuple]) -> torch.device:
    device = named["h"].device
    for name, x in named.items():
        if x.device != device:
            raise ValueError(f"gap_substeps: {name} is on {x.device}, h on "
                             f"{device}")
        if x.dtype != torch.float32:
            raise TypeError(f"gap_substeps: the CUDA kernel takes float32, "
                            f"{name} is {x.dtype}")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"gap_substeps: {name} has shape "
                             f"{tuple(x.shape)}, expected {shapes[name]}")
        if not x.is_contiguous():
            raise ValueError(f"gap_substeps: {name} must be contiguous")
    return device


def gap_substeps(h, base, t_last, t_target, w1h, w1t, w2, b2,
                 dt: float, n_sub: int, act_name: str, scale_name: str):
    """The full-step loop: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors, an error for anything else.  Same arguments and
    result as :func:`gap_substeps_reference`."""
    global LAUNCHES
    tensors = {"h": h, "base": base, "t_last": t_last, "t_target": t_target,
               "w1h": w1h, "w1t": w1t, "w2": w2, "b2": b2}
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in tensors.values()):
        raise RuntimeError(
            "gap_substeps has no backward yet (the gap_scan backward kernels "
            "are still to be ported); call it under torch.no_grad()")
    if all(x.device.type == "cpu" for x in tensors.values()):
        return gap_substeps_reference(h, base, t_last, t_target, w1h, w1t,
                                      w2, b2, dt, n_sub, act_name, scale_name)
    if h.device.type != "cuda":
        raise ValueError(f"gap_substeps: no kernel for device {h.device} "
                         "(or tensors on mixed devices)")
    if act_name not in SUPPORTED_ACTS or scale_name not in _SCALE:
        raise ValueError(f"gap_substeps: unsupported activation/scaling "
                         f"{act_name!r}/{scale_name!r}")
    K, R, d_h = h.shape
    mat, vec, row = (K, d_h, d_h), (K, d_h), (R,)
    device = _check_cuda_inputs(tensors, {
        "h": (K, R, d_h), "base": (K, R, d_h), "t_last": row, "t_target": row,
        "w1h": mat, "w1t": vec, "w2": mat, "b2": vec})
    if n_sub < 0 or not dt > 0.0:
        raise ValueError(f"gap_substeps: need n_sub >= 0 and dt > 0, got "
                         f"{n_sub}, {dt}")
    lib, fn = _load_kernel()
    h_out = torch.empty_like(h)
    t_out = torch.empty_like(t_last)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(h.data_ptr(), base.data_ptr(), t_last.data_ptr(),
                 t_target.data_ptr(), w1h.data_ptr(), w1t.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), h_out.data_ptr(),
                 t_out.data_ptr(), K, R, d_h, float(dt), int(n_sub),
                 SUPPORTED_ACTS.index(act_name), SCALINGS.index(scale_name),
                 stream)
    from ._build import check
    check(lib, err, "njode_gap_scan_fwd launch")
    LAUNCHES += 1
    return h_out, t_out


# --------------------------------------------------------------------------
# the whole gap: weights, hoisted base, full steps, final partial step
# --------------------------------------------------------------------------

class GapWeights(NamedTuple):
    """The ODEFunc weights stacked on K_h, matrices in (in, out)
    orientation, all contiguous.

    w1: (K_h, d_h+d_x+2, d_h), rows [h, x, t_rel, t_elapsed]; b1: (K_h, d_h);
    w2: (K_h, d_h, d_h); b2: (K_h, d_h); and apart, as the kernel reads
    them, W1's h rows w1h: (K_h, d_h, d_h) and t_rel row w1t: (K_h, d_h).
    """
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w1h: torch.Tensor
    w1t: torch.Tensor


def split_weights(ode_weights: Sequence[torch.Tensor]) -> GapWeights:
    """:class:`GapWeights` from (W1, b1, W2, b2), stacked on K_h in torch's
    (out, in) orientation: (K_h, d_h, d_h+d_x+2), (K_h, d_h), (K_h, d_h, d_h),
    (K_h, d_h)."""
    w1, b1, w2, b2 = ode_weights
    d_h = w2.shape[-1]
    d_x = w1.shape[-1] - d_h - 2
    if d_x < 0 or w1.shape[:2] != w2.shape[:2]:
        raise ValueError(f"ODEFunc W1 {tuple(w1.shape)} does not fit W2 "
                         f"{tuple(w2.shape)}: expected (K, d_h, d_h+d_x+2)")
    w1_io = w1.transpose(1, 2).contiguous()
    return GapWeights(w1_io, b1.contiguous(), w2.transpose(1, 2).contiguous(),
                      b2.contiguous(), w1_io[:, :d_h].contiguous(),
                      w1_io[:, d_h + d_x].contiguous())


def substep_inputs(h, x_scaled, t_last, t_target, w: GapWeights,
                   dt_ode_step: float):
    """Hoist the part of the pre-activation constant across full substeps,
    base = s(x) W1x + dt w1dt + b1 (x and the full-step t_elapsed = dt are
    fixed within a gap): the first eight arguments of :func:`gap_substeps`,
    contiguous."""
    K, R, d_h = h.shape
    d_x = x_scaled.shape[-1]
    if w.w1.shape != (K, d_h + d_x + 2, d_h):
        raise ValueError(f"ODEFunc W1 has shape {tuple(w.w1.shape)}, expected "
                         f"{(K, d_h + d_x + 2, d_h)}")
    b = torch.add(w.b1, w.w1[:, -1], alpha=float(dt_ode_step))[:, None]
    base = torch.baddbmm(b, x_scaled.expand(K, R, d_x),
                         w.w1[:, d_h:d_h + d_x])
    return (h.contiguous(), base, t_last.contiguous(), t_target.contiguous(),
            w.w1h, w.w1t, w.w2, w.b2)


def _integrate(substeps, h, x_scaled, t_last, t_target, w: GapWeights,
               dt_ode_step: float, max_substeps: int, act_name: str,
               scale_name: str):
    K, R, d_x = h.shape[0], h.shape[1], x_scaled.shape[-1]
    act, scale = _ACT[act_name], _SCALE[scale_name]
    h_l, t_l = substeps(*substep_inputs(h, x_scaled, t_last, t_target, w,
                                        dt_ode_step),
                        float(dt_ode_step), int(max_substeps), act_name,
                        scale_name)
    # final partial step to exactly t_target (reference :201-202), features
    # [s(h), s(x), t_rel = t_L, t_elapsed = t_target - t_L]
    t_el = t_target - t_l
    inp = torch.cat([scale(h_l), x_scaled.expand(K, R, d_x),
                     t_l[None, :, None].expand(K, R, 1),
                     t_el[None, :, None].expand(K, R, 1)], dim=-1)
    pre = torch.baddbmm(w.b1[:, None], inp, w.w1)
    dh = torch.baddbmm(w.b2[:, None], act(pre), w.w2)
    h_fin = torch.addcmul(h_l, t_el[None, :, None], dh)
    return torch.where((t_l < t_target)[None, :, None], h_fin, h_l), t_l


def integrate_gap_fused(h, x_scaled, t_last, t_target, weights: GapWeights,
                        dt_ode_step: float, max_substeps: int,
                        act_name: str, scale_name: str):
    """Whole-gap integration for all K_h moment networks, full steps in the
    CUDA kernel (its plain version on the CPU).

    Args:
      h:        (K_h, R, d_h) jump states (one gap per row).
      x_scaled: (R, d_x) input-scaled last observations.
      t_last, t_target: (R,) gap boundaries.
      weights:  the ODEFunc's :class:`GapWeights` (see :func:`split_weights`).

    Returns: ((K_h, R, d_h) latent states at t_target, (R,) t_L, the time
      the full steps reached).
    """
    return _integrate(gap_substeps, h, x_scaled, t_last, t_target, weights,
                      dt_ode_step, max_substeps, act_name, scale_name)


def integrate_gap_reference(h, x_scaled, t_last, t_target,
                            weights: GapWeights, dt_ode_step: float,
                            max_substeps: int, act_name: str,
                            scale_name: str):
    """Plain PyTorch version of :func:`integrate_gap_fused` on any device."""
    return _integrate(gap_substeps_reference, h, x_scaled, t_last, t_target,
                      weights, dt_ode_step, max_substeps, act_name,
                      scale_name)
