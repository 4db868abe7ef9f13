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
logical shapes.  Both walk each row on a group of warps that split every
product (the walk-train kernel's design); the backward writes at every cell
the records the weight cotangents are sums over, and sums them afterwards
as long-k products in a fixed order; :func:`walk_fwd_plan` and
:func:`walk_bwd_plan` are their launch plans,
:func:`walk_forward_reference` and :func:`walk_backward_reference` the plain
versions of that data flow.  See the source for the design.

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
from typing import NamedTuple, Optional, Sequence

import torch

from .activations import (_ACT, _ACT_GRAD, _SCALE, _SCALE_GRAD,
                          SCALINGS, SUPPORTED_ACTS)
from .gap_scan import gap_scan_decline

# launches of the forward and backward kernels in this process; callers may
# reset them to 0
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
# the kernels' widest hidden size (4 columns per lane)
MAX_HIDDEN = 128
SMEM_BYTES = 232_448           # the H100's opt-in shared memory per block
# rows 7 and 8's launch plans (csrc/walk_scan.cu): a row's warps by the
# walk's rows (B K): 4 up to BWD_WPT_ROWS[0], 2 up to BWD_WPT_ROWS[1], else
# 1; at most BWD_MAX_WARPS warps a block; row 8's weight sums over chunks of
# at least DW_MIN_CHUNK record rows, at most DW_MAX_CHUNKS chunks a network
BWD_WPT_ROWS = (512, 1024)
BWD_MAX_WARPS = 8
DW_MIN_CHUNK, DW_MAX_CHUNKS = 128, 256


class WalkFwdPlan(NamedTuple):
    """Row 7's launch plan: warps a row (its group), warps a block, the
    walk's shared bytes."""
    wpt: int
    warps: int
    smem: int

    def ints(self) -> list[int]:
        """The plan as njode_walk_fwd takes it."""
        return [self.wpt, self.warps]


class WalkBwdPlan(NamedTuple):
    """Row 8's launch plan: warps a row (its group), warps a block, the
    record rows of a chunk of the weight sums and their chunks, and the
    walk's shared bytes."""
    wpt: int
    warps: int
    chunk_rows: int
    chunks: int
    smem: int

    def ints(self) -> list[int]:
        """The plan as njode_walk_bwd takes it."""
        return [self.wpt, self.warps, self.chunk_rows]


def _bwd_smem_bytes(d: int, N: int, wpt: int, warps: int) -> int:
    """csrc/walk_scan.cu's ``walk_smem_bytes`` (both walks): the W1h and W2
    planes (HP x (HP + 1), HP 64 or 128), each row's two partial-product
    buffers of its group, each row's reset and read cells."""
    hp, rpb = (64 if d <= 64 else 128), warps // wpt
    return 4 * (2 * hp * (hp + 1) + rpb * 2 * wpt * hp + 2 * rpb * N)


def _walk_group(d: int, B: int, N: int, K: int) -> tuple[int, int] | None:
    """A row's warps by the walk's rows B K (``BWD_WPT_ROWS``) and the
    block's warps, halving from ``BWD_MAX_WARPS`` until the block fits the
    shared memory; None where it never does."""
    rows = B * K
    wpt = 4 if rows <= BWD_WPT_ROWS[0] else 2 if rows <= BWD_WPT_ROWS[1] else 1
    warps = BWD_MAX_WARPS
    while warps > wpt and _bwd_smem_bytes(d, N, wpt, warps) > SMEM_BYTES:
        warps //= 2
    if _bwd_smem_bytes(d, N, wpt, warps) > SMEM_BYTES:
        return None
    return wpt, warps


@functools.lru_cache(maxsize=None)
def walk_fwd_plan(d: int, B: int, N: int, M: int,
                  K: int = 1) -> Optional[WalkFwdPlan]:
    """Row 7's launch plan, or None where the shapes do not fit: the
    backward's groups (:func:`walk_bwd_plan`), so that at the production
    shape (256 rows, K_h 2) each row walks on 4 warps, 2,048 warps in all."""
    d, B, N, M, K = int(d), int(B), int(N), int(M), int(K)
    if not (1 <= d <= MAX_HIDDEN and B >= 1 and N >= 2 and M >= 0
            and K >= 1):
        return None
    group = _walk_group(d, B, N, K)
    if group is None:
        return None
    return WalkFwdPlan(*group, _bwd_smem_bytes(d, N, *group))


@functools.lru_cache(maxsize=None)
def walk_bwd_plan(d: int, B: int, N: int, M: int,
                  K: int = 1) -> Optional[WalkBwdPlan]:
    """Row 8's launch plan, or None where the shapes do not fit.  A row's
    warps follow the walk's rows B K (``BWD_WPT_ROWS``), so that the card
    holds several warps a scheduler; warps a block halve from
    ``BWD_MAX_WARPS`` until the block fits the shared memory; the M B
    record rows of a network are summed in chunks of a multiple of 32
    rows."""
    d, B, N, M, K = int(d), int(B), int(N), int(M), int(K)
    if not (1 <= d <= MAX_HIDDEN and B >= 1 and N >= 2 and M >= 0
            and K >= 1):
        return None
    group = _walk_group(d, B, N, K)
    if group is None:
        return None
    wpt, warps = group
    smem = _bwd_smem_bytes(d, N, wpt, warps)
    mb = M * B
    per_chunk = -(-mb // DW_MAX_CHUNKS)
    chunk_rows = max(DW_MIN_CHUNK, -(-per_chunk // 32) * 32)
    return WalkBwdPlan(wpt, warps, chunk_rows, -(-mb // chunk_rows), smem)


def walk_scan_decline(n_hidden_layers: int, activation: str,
                      dropout_rate: float, input_scaling: str,
                      input_dim: int, hidden_dim: int) -> Optional[str]:
    """The first reason the kernels do not compute this ODEFunc, or None
    (canonical names expected)."""
    reason = gap_scan_decline(n_hidden_layers, activation, dropout_rate,
                              input_scaling)
    if reason is not None:
        return reason
    if input_dim != 1:
        return f"input_dim {input_dim} != 1"
    if not 1 <= hidden_dim <= MAX_HIDDEN:
        return f"hidden_dim {hidden_dim} outside 1..{MAX_HIDDEN}"
    return None


def walk_scan_available(n_hidden_layers: int, activation: str,
                        dropout_rate: float, input_scaling: str,
                        input_dim: int, hidden_dim: int) -> bool:
    """Whether the kernels compute this ODEFunc (canonical names expected);
    the grid-alignment promise is the caller's."""
    return walk_scan_decline(n_hidden_layers, activation, dropout_rate,
                             input_scaling, input_dim, hidden_dim) is None


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


def _walk_split(w1_io, d):
    return w1_io[:, :d], w1_io[:, d], w1_io[:, d + 1]


def walk_forward_reference(hj, xs, ts, reset, read, w1_io, cvec, w2_io, b2,
                           dt: float, M: int, act_name: str,
                           scale_name: str):
    """Plain PyTorch version of the forward kernel (row 7) with its
    residuals, on the kernel's own arguments: hj (K, B, N, d); xs, ts (B,
    N) (x scaled); reset, read (B, N) int32 (:func:`slot_cells`); w1_io (K,
    d+3, d), cvec (K, d), w2_io (K, d, d), b2 (K, d) as
    :func:`split_walk_weights` returns them.  Returns (h_minus (K, B, N-1,
    d), res_h (K, M, B, d), res_t (M, B), res_x (M, B)): the post-reset
    carry of every cell."""
    act, scale = _ACT[act_name], _SCALE[scale_name]
    d = hj.shape[-1]
    w1h, w1x, w1t = _walk_split(w1_io, d)
    res = []

    def euler(h, x, t):
        res.append((h, t, x))
        pre = (torch.matmul(scale(h), w1h) + x[None, :, None] * w1x[:, None]
               + t[None, :, None] * w1t[:, None] + cvec[:, None])
        return h + dt * (torch.matmul(act(pre), w2_io) + b2[:, None])

    h_minus = walk_cells(hj, xs[..., None], ts, reset, read, M, dt,
                         lambda h, x, t: euler(h, x[:, 0], t))
    K, B = hj.shape[:2]
    if not res:
        empty = hj.new_zeros(0, B)
        return h_minus, hj.new_zeros(K, 0, B, d), empty, empty
    return (h_minus, torch.stack([r[0] for r in res], 1),
            torch.stack([r[1] for r in res]), torch.stack([r[2] for r in res]))


def walk_backward_reference(ct_hm, res_h, res_t, res_x, reset, read, w1_io,
                            cvec, w2_io, dt: float, act_name: str,
                            scale_name: str, chunk_rows: Optional[int] = None):
    """Plain PyTorch version of the backward (row 8) with the kernel's data
    flow: the cells in reverse, each recomputing pre from its residual and
    writing the records hid = act(pre), gp (the pre-activation's cotangent)
    and gdh = dt x the carry's cotangent; the carry's cotangent at a reset
    goes to its jump slot, the reads of a cell are added slot by slot.  Then
    the weight sums as long-k products over the M B record rows of each
    network, [s(h), x, t, 1]^T gp and [hid, 1]^T gdh, each chunk of
    ``chunk_rows`` rows (:func:`walk_bwd_plan`'s by default) summed alone
    and the chunks added in order.  ct_hm (K, B, N-1, d); the rest as
    :func:`walk_forward_reference` returns or takes them.  Returns (ct_hj
    (K, B, N, d), grads (K, 2 d^2 + 4 d) = [dW1h, dW2, dw1x, dw1t, dcvec,
    db2], each matrix (in, out))."""
    act, dact = _ACT[act_name], _ACT_GRAD[act_name]
    scale, dscale = _SCALE[scale_name], _SCALE_GRAD[scale_name]
    K, M, B, d = res_h.shape
    N = reset.shape[1]
    w1h, w1x, w1t = _walk_split(w1_io, d)
    gh = ct_hm.new_zeros(K, B, d)
    ct_hj = ct_hm.new_zeros(K, B, N, d)

    def add_reads(gh, g):
        for s in range(1, N):
            hit = (read[:, s] == g)[None, :, None]
            gh = gh + torch.where(hit, ct_hm[:, :, s - 1], 0.0)
        return gh
    gh = add_reads(gh, M)
    hid, gp, gdh = [None] * M, [None] * M, [None] * M
    for g in reversed(range(M)):
        h, t, x = res_h[:, g], res_t[g], res_x[g]
        pre = (torch.matmul(scale(h), w1h) + x[None, :, None] * w1x[:, None]
               + t[None, :, None] * w1t[:, None] + cvec[:, None])
        hid[g], gdh[g] = act(pre), dt * gh
        gp[g] = torch.matmul(gdh[g], w2_io.transpose(1, 2)) * dact(pre)
        gh = gh + torch.matmul(gp[g], w1h.transpose(1, 2)) * dscale(h)
        hits = reset == g                                  # (B, N)
        for s in range(N):
            ct_hj[:, hits[:, s], s] = gh[:, hits[:, s]]
        gh = torch.where(hits.any(1)[None, :, None], 0.0, gh)
        gh = add_reads(gh, g)
    mb = M * B
    if chunk_rows is None:
        chunk_rows = walk_bwd_plan(d, B, N, M, K).chunk_rows
    out = []
    if M:
        ones = res_h.new_ones(K, M, B, 1)
        col = (lambda v: v[None, ..., None].expand(K, M, B, 1))
        a0 = torch.cat([scale(res_h), col(res_x), col(res_t), ones], -1)
        a1 = torch.cat([torch.stack(hid, 1), ones], -1)
        for a, gm in ((a0, torch.stack(gp, 1)), (a1, torch.stack(gdh, 1))):
            a, gm = a.reshape(K, mb, -1), gm.reshape(K, mb, d)
            total = None
            for c0 in range(0, mb, chunk_rows):
                part = torch.matmul(a[:, c0:c0 + chunk_rows].transpose(1, 2),
                                    gm[:, c0:c0 + chunk_rows])
                total = part if total is None else total + part
            out.append(total)
    else:
        out = [res_h.new_zeros(K, d + 3, d), res_h.new_zeros(K, d + 1, d)]
    s1, s2 = out
    grads = torch.cat([s1[:, :d].reshape(K, d * d),
                       s2[:, :d].reshape(K, d * d),
                       s1[:, d], s1[:, d + 1], s1[:, d + 2], s2[:, d]], -1)
    return ct_hj, grads


def weight_cotangents(grads, d: int, dt: float):
    """The ODEFunc weights' cotangents, torch orientation, from the
    backward's sums (K, 2 d^2 + 4 d): W1's t_elapsed column gets dt times
    the cotangent of cvec, b1 that cotangent.  Returns (dW1, db1, dW2,
    db2)."""
    K, dd = grads.shape[0], d * d
    d_w1h = grads[:, :dd].reshape(K, d, d)
    d_w2 = grads[:, dd:2 * dd].reshape(K, d, d)
    d_w1x, d_w1t, d_cvec, d_b2 = grads[:, 2 * dd:].reshape(K, 4, d).unbind(1)
    d_w1 = torch.cat([d_w1h, d_w1x[:, None], d_w1t[:, None],
                      (dt * d_cvec)[:, None]], dim=1)     # (in, out)
    return d_w1.transpose(1, 2), d_cvec, d_w2.transpose(1, 2), d_b2


def walk_vjp_reference(h_jump, x_scaled, times, mask, g_idx,
                       weights: Sequence[torch.Tensor], dt_ode_step: float,
                       n_cells: int, act_name: str, scale_name: str, ct):
    """The kernel pair's plain versions end to end: h_minus (K, B*(N-1), d)
    as :func:`walk_gaps_fused` returns it, and the cotangents [h_jump, W1,
    b1, W2, b2] of ``ct`` (K, B*(N-1), d) through
    :func:`walk_backward_reference`."""
    K, B, N, d = h_jump.shape
    dt, M = float(dt_ode_step), int(n_cells)
    reset, read = slot_cells(mask, g_idx, M)
    w1_io, cvec, w2_io, b2 = split_walk_weights(weights, dt)
    h_minus, res_h, res_t, res_x = walk_forward_reference(
        h_jump, x_scaled[..., 0], times, reset, read, w1_io, cvec, w2_io, b2,
        dt, M, act_name, scale_name)
    ct_hj, grads = walk_backward_reference(
        ct.reshape(K, B, N - 1, d), res_h, res_t, res_x, reset, read, w1_io,
        cvec, w2_io, dt, act_name, scale_name)
    return (h_minus.reshape(K, B * (N - 1), d),
            [ct_hj, *weight_cotangents(grads, d, dt)])


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

@functools.cache
def _load_kernel():
    """Build (first call only) and bind ``njode_walk_fwd``/``_bwd``."""
    from ._build import load
    lib = load("walk_scan")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.njode_walk_fwd.argtypes = ([P] * 13 + [I] * 5 + [F] + [I] * 2
                                   + [ctypes.POINTER(I), ctypes.c_longlong, P])
    lib.njode_walk_fwd.restype = I
    lib.njode_walk_bwd.argtypes = ([P] * 13 + [I] * 5 + [F] + [I] * 2
                                   + [ctypes.POINTER(I), ctypes.c_longlong, P])
    lib.njode_walk_bwd.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _plan_arg(plan: WalkFwdPlan):
    """The plan as the C array njode_walk_fwd reads (one a plan)."""
    return (ctypes.c_int * 2)(*plan.ints())


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
        plan = walk_fwd_plan(d, B, N, M, K)
        if plan is None:
            raise ValueError(f"WalkScan: no forward plan fits d_h {d}, "
                             f"{N} slots")
        lib = _load_kernel()
        with torch.cuda.device(dev):
            err = lib.njode_walk_fwd(
                hj.data_ptr(), xs.data_ptr(), ts.data_ptr(), reset.data_ptr(),
                read.data_ptr(), w1_io.data_ptr(), cvec.data_ptr(),
                w2_io.data_ptr(), b2c.data_ptr(), h_minus.data_ptr(),
                *(_ptr(r) for r in res), K, B, N, d, M, float(dt),
                SUPPORTED_ACTS.index(act_name), SCALINGS.index(scale_name),
                _plan_arg(plan), plan.smem, _stream(dev))
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
        plan = walk_bwd_plan(d, B, N, M, K)
        if plan is None:
            raise ValueError(f"WalkScan: no backward plan fits d_h {d}, "
                             f"{N} slots")
        lib = _load_kernel()
        P = 2 * d * d + 4 * d
        records = torch.empty(3 * K * M * B * d, dtype=torch.float32,
                              device=dev)
        partial = torch.empty(plan.chunks * K * P, dtype=torch.float32,
                              device=dev)
        grads = torch.empty(K, P, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.njode_walk_bwd(
                ct_hm.data_ptr(), res_h.data_ptr(), res_t.data_ptr(),
                res_x.data_ptr(), reset.data_ptr(), read.data_ptr(),
                w1_io.data_ptr(), cvec.data_ptr(), w2_io.data_ptr(),
                ct_hj.data_ptr(), records.data_ptr(), partial.data_ptr(),
                grads.data_ptr(), K, B, N, d, M, dt,
                SUPPORTED_ACTS.index(act_name), SCALINGS.index(scale_name),
                (ctypes.c_int * 3)(*plan.ints()), plan.smem, _stream(dev))
        from ._build import check
        check(lib, err, "njode_walk_bwd launch")
        LAUNCHES_BWD += 1
        return (ct_hj, *weight_cotangents(grads, d, dt),
                None, None, None, None, None, None, None, None)


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
