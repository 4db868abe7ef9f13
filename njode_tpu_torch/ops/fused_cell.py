"""The fused Euler cell: one ODEFunc Euler step as one CUDA kernel.

Port of ``njode_tpu/ops/fused_cell.py``.  Under ``use_pallas=True`` every
Euler step of the model's ``_euler`` that the cell computes (one hidden
layer, no dropout, an activation with an analytic derivative) goes through
it: the whole gap of a model without ``dt_ode_step``, the substeps of the
plain loop and the plain walk, and ``predict_at``.

    inp = [s(h), s(x), t_rel, t_elapsed]               (K, R, d_in)
    pre = inp W1 + b1,    out = h + dt (act(pre) W2 + b2)

Kernel: ``csrc/fused_cell.cu`` (``njode_fused_cell``) replaces the TPU
kernel ``njode_tpu/ops/fused_cell.py:_kernel`` (line 73) and stores ``pre``
for the backward as it does.  The JAX package launches that kernel once per
network on lane-padded tiles; here one launch covers all K_h stacked
networks at their logical shapes, so ``LAUNCHES`` counts one per
:func:`ode_euler_fused` call.  The backward is ``_bwd``'s algebra
(``fused_cell.py:137-156``) in plain PyTorch, as the JAX package leaves it
to XLA.

Wrappers: :class:`FusedEulerCell`, a ``torch.autograd.Function``, launches
the kernel for CUDA tensors and takes :func:`fused_cell_reference` only for
CPU tensors; :func:`ode_euler_fused` is the model-facing step and
:func:`ode_euler_reference` its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .activations import _ACT, _ACT_GRAD, SUPPORTED_ACTS

# launches of the CUDA kernel in this process; callers may reset it to 0
LAUNCHES = 0


def fused_cell_available(n_hidden_layers: int, activation: str,
                         dropout_rate: float) -> bool:
    """Whether the cell computes this ODEFunc (canonical names expected):
    two layers, no dropout, an analytic-gradient activation.  Like the JAX
    gate it has no input-scaling condition: the scaling is applied outside
    the cell."""
    return (n_hidden_layers == 1 and dropout_rate == 0.0
            and activation in SUPPORTED_ACTS)


def fused_cell_reference(inp, h, dt, w1, b1, w2, b2, act_name: str):
    """Plain PyTorch version of the kernel: (out, pre).

    inp (K, R, d_in); h (K, R, d_h); dt (R,); w1 (K, d_in, d_h) and w2
    (K, d_h, d_h) as (in, out); b1, b2 (K, d_h)."""
    pre = torch.baddbmm(b1[:, None], inp, w1)
    dh = torch.baddbmm(b2[:, None], _ACT[act_name](pre), w2)
    return h + dt[None, :, None] * dh, pre


@functools.cache
def _load_kernel():
    """Build (first call only) and bind ``njode_fused_cell``."""
    from ._build import load
    lib = load("fused_cell")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.njode_fused_cell.argtypes = [P] * 9 + [I] * 5 + [P]
    lib.njode_fused_cell.restype = I
    return lib


def _launch(inp, h, dt, w1, b1, w2, b2, act_name: str):
    """The kernel: (out, pre) as :func:`fused_cell_reference` returns."""
    global LAUNCHES
    K, R, d_in = inp.shape
    d_h = h.shape[-1]
    shapes = {"inp": (K, R, d_in), "h": (K, R, d_h), "dt": (R,),
              "w1": (K, d_in, d_h), "b1": (K, d_h), "w2": (K, d_h, d_h),
              "b2": (K, d_h)}
    named = dict(zip(shapes, (inp, h, dt, w1, b1, w2, b2)))
    dev = inp.device
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"fused_cell: {name} is on {x.device}, inp on "
                             f"{dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"fused_cell: the CUDA kernel takes float32, "
                            f"{name} is {x.dtype}")
        if tuple(x.shape) != shapes[name] or not x.is_contiguous():
            raise ValueError(f"fused_cell: {name} has shape "
                             f"{tuple(x.shape)}, expected {shapes[name]}, "
                             "contiguous")
    if act_name not in SUPPORTED_ACTS:
        raise ValueError(f"fused_cell: unsupported activation {act_name!r}")
    lib = _load_kernel()
    out, pre = torch.empty_like(h), torch.empty_like(h)
    with torch.cuda.device(dev):
        err = lib.njode_fused_cell(
            *(x.data_ptr() for x in named.values()), out.data_ptr(),
            pre.data_ptr(), K, R, d_in, d_h, SUPPORTED_ACTS.index(act_name),
            torch.cuda.current_stream(dev).cuda_stream)
    from ._build import check
    check(lib, err, "njode_fused_cell launch")
    LAUNCHES += 1
    return out, pre


class FusedEulerCell(torch.autograd.Function):
    """(inp, h, dt, w1, b1, w2, b2) -> h + dt (act(inp w1 + b1) w2 + b2),
    the forward in the kernel (its plain version for CPU tensors), the
    backward ``_bwd``'s algebra in plain PyTorch: every input gets its
    cotangent."""

    @staticmethod
    def forward(ctx, inp, h, dt, w1, b1, w2, b2, act_name):
        args = [x.contiguous() for x in (inp, h, dt, w1, b1, w2, b2)]
        if all(x.device.type == "cpu" for x in args):
            out, pre = fused_cell_reference(*args, act_name)
        elif inp.device.type == "cuda":
            out, pre = _launch(*args, act_name)
        else:
            raise ValueError(f"fused_cell: no kernel for device "
                             f"{inp.device} (or tensors on mixed devices)")
        inp_c, _, dt_c, w1_c, _, w2_c, b2_c = args
        ctx.save_for_backward(inp_c, dt_c, pre, w1_c, w2_c, b2_c)
        ctx.act_name = act_name
        return out

    @staticmethod
    def backward(ctx, g):
        inp, dt, pre, w1, w2, b2 = ctx.saved_tensors
        hidden = _ACT[ctx.act_name](pre)
        g_dh = g * dt[None, :, None]
        g_pre = torch.matmul(g_dh, w2.transpose(1, 2)) * _ACT_GRAD[
            ctx.act_name](pre)
        dh = torch.baddbmm(b2[:, None], hidden, w2)
        return (torch.matmul(g_pre, w1.transpose(1, 2)), g,
                (g * dh).sum((0, 2)),
                torch.matmul(inp.transpose(1, 2), g_pre), g_pre.sum(1),
                torch.matmul(hidden.transpose(1, 2), g_dh), g_dh.sum(1),
                None)


def fused_euler_cell(inp, h, dt, w1, b1, w2, b2, act_name: str = "relu"):
    """``h + dt (act(inp @ w1 + b1) @ w2 + b2)`` for one network, the JAX
    entry of this name (``njode_tpu/ops/fused_cell.py:117``) at logical
    shapes: inp (R, d_in), h (R, d_h), dt (R,) or (R, 1) (the JAX entry's
    dt_col holds a row's dt in every column), w1 (d_in, d_h), b1 (d_h,),
    w2 (d_h, d_h), b2 (d_h,).  The kernel for CUDA tensors, its plain
    version for CPU tensors; differentiable in every input."""
    out = FusedEulerCell.apply(inp[None], h[None], dt.reshape(-1), w1[None],
                               b1[None], w2[None], b2[None], act_name)
    return out[0]


def _cell_inputs(h, x_scaled, h_scaled, t_cur, t_new,
                 ode_weights: Sequence[torch.Tensor]):
    """inp = [s(h), s(x), t_rel = t_cur, t_elapsed = t_new - t_cur], dt,
    and the weights turned to (in, out), all differentiable."""
    K, B, _ = h.shape
    t_el = (t_new - t_cur).to(h.dtype)
    inp = torch.cat([h_scaled, x_scaled.expand(K, B, x_scaled.shape[-1]),
                     t_cur.to(h.dtype)[None, :, None].expand(K, B, 1),
                     t_el[None, :, None].expand(K, B, 1)], dim=-1)
    w1, b1, w2, b2 = ode_weights
    return inp, t_el, w1.transpose(1, 2), b1, w2.transpose(1, 2), b2


def ode_euler_fused(h, x_scaled, h_scaled, t_cur, t_new,
                    ode_weights: Sequence[torch.Tensor], act_name: str):
    """One Euler step from t_cur to t_new for all K_h networks
    (``njode_tpu/ops/fused_cell.py:170-219``): the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors, differentiable either way.

    Args:
      h:        (K_h, B, d_h) states before the step.
      x_scaled: (B, d_x) input-scaled last observations.
      h_scaled: (K_h, B, d_h) input-scaled h (the ODEFunc's features).
      t_cur, t_new: (B,) step boundaries.
      ode_weights: (W1, b1, W2, b2) stacked on K_h, torch's (out, in)
        orientation: (K_h, d_h, d_h+d_x+2), (K_h, d_h), (K_h, d_h, d_h),
        (K_h, d_h).

    Returns: (K_h, B, d_h) states after the step.
    """
    inp, dt, w1, b1, w2, b2 = _cell_inputs(h, x_scaled, h_scaled, t_cur,
                                           t_new, ode_weights)
    return FusedEulerCell.apply(inp, h, dt, w1, b1, w2, b2, act_name)


def ode_euler_reference(h, x_scaled, h_scaled, t_cur, t_new,
                        ode_weights: Sequence[torch.Tensor], act_name: str):
    """Plain PyTorch version of :func:`ode_euler_fused` on any device,
    differentiable by autograd."""
    inp, dt, w1, b1, w2, b2 = _cell_inputs(h, x_scaled, h_scaled, t_cur,
                                           t_new, ode_weights)
    return fused_cell_reference(inp, h, dt, w1, b1, w2, b2, act_name)[0]
