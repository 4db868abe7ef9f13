"""The fused whole training step: jump -> one Euler step -> readout, all slots.

Port of ``njode_tpu/ops/fused_step.py``.  Without ``dt_ode_step`` every gap
is one Euler step, and the jump resets the latent state at every
observation, so the whole forward of ``NeuralJumpODE.apply`` is local to
each (trajectory, slot): per network kn (Kn = K separate, or 1 shared)

    HJ_s = act(... act(sum_d x_s[d] j1[d] + bj0) @ J_1 + bj_1 ...)     jump
    BASE = t_{s-1} w1t + (t_s - t_{s-1}) w1d + b1 + sum_d s(x_{s-1}[d]) w1x[d]
    G    = act(s(HJ_{s-1}) @ W1h + BASE), then the mid layers            ODE
    HM_s = HJ_{s-1} + DT (G @ Wlast + blast)                  one Euler step
    y    = act(... act(U @ O_0 + bo_0) ...) . o2   for U in [HJ_s; HM_s]  readout

x enters the jump layer unscaled and the ODE layer scaled (``s(x)``,
``s(h)``).  The readout's bias bo2 stays outside the kernels and is added
differentiably, as in the JAX package.

Kernels: ``csrc/fused_step.cu``, ``njode_step_fwd`` (replaces the TPU kernel
``fused_step.py:223`` ``_fwd_kernel``) and ``njode_step_bwd`` (replaces
``:316`` ``_bwd_kernel``: rematerialize, then the reverse chain, returning
the parameter cotangents dW and dV), joined by :class:`FusedStep`, a
``torch.autograd.Function``.  As in the JAX ``custom_vjp``, times and values
get no cotangent.

The layout (:class:`StepLayout`) keeps the JAX package's planes and rows at
logical shapes: W (Kn, n_mats, H, H), each plane in (in, out) orientation,
V (Kn, n_rows, H).  Not copied (TPU layout, not semantics): the 128-lane
padding, the 16-row minimum of V, the lane packing of inputs and outputs
and the lane-space loss, whose value and gradients
:func:`fused_step_loss_packed` reproduces as ``nj_ode_loss_dense`` of
:func:`fused_step_apply_packed`.

The port's own shape gate (:func:`fused_step_fits`): 1 <= H <= 256 and a
block's working set of both instances in the H100's 227 KB of shared
memory.  The bf16 instances (:func:`launch_plan`): 8 warps of up to 4
tensor-core n-tiles, the weight stage (3 slices of 16 bf16 rows), 2
(forward) or 3 L + 3 (backward) buffers of RT padded rows of H floats and
the tile's scalars, with RT 64 rows forward and 32 or 16 backward; at H
256 that admits N up to 94 at L 1-2 and 11 at L 3.  The f32 instances
(:func:`f32_plan`): 8 warps over RT = 64, 32 or 16 trajectories, the
slots in groups of SG, the weight stage (3 slices of 8 f32 rows), one
buffer of the group's rows (the slots and their gaps) and the tile's
scalars; they fit wherever the bf16 instances do.  Every recipe of the
repo fits.
``use_pallas="auto"`` takes the kernels on the card only at the shape an
H100 A/B measured ahead (``AUTO_SHAPE_H100``, ``AUTO_MIN_BATCH_H100``), in
the compute dtypes it measured (``AUTO_COMPUTE_DTYPES_H100``).

The f32 backward (row 10) writes each plane's input rows and cotangents
as records and sums dW = A^T G over the whole batch in a second pass;
:func:`fused_step_records_reference` and :func:`step_dw_reference` are the
plain versions of those two passes.

Mixed precision (``compute_dtype=torch.bfloat16``, the JAX kernels' ``cdt``
mode, ``fused_step.py:236-239``, ``:336-346``, ``:503-560``): W is cast to
bf16 once, outside the kernels, and the backward's WT is the transpose of
the cast planes; every product rounds its activation operand to bf16 (the
weight-gradient sums A^T G both operands) and accumulates in float32; V,
the epilogues, the activations and the column sums stay float32, and dW
comes back in float32.  The kernels' bf16 instances (rows 9b and 10b) run
their products and weight-gradient sums on the tensor cores (the f32 ones
on the CUDA cores) and are counted apart from the float32 ones
(``LAUNCHES_FWD_BF16`` / ``LAUNCHES_BWD_BF16``).  float16 has no fused
step (JAX ``:716``).

Wrappers: :func:`fused_step_apply_packed` / :func:`fused_step_loss_packed`
take the kernels for CUDA tensors and the plain versions
:func:`fused_step_forward_reference` / :func:`fused_step_backward_reference`
only for CPU tensors; :func:`fused_step_apply` / :func:`fused_step_loss`
take the model and pack its parameters, as the JAX entries of those names
take the parameter pytree.  :func:`pack_params` / :func:`unpack_params` map
the model's modules to (W, V, bo2) and back; packing is differentiable, so
autograd carries dW and dV back to the modules' parameters.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .activations import _ACT, _ACT_GRAD, _SCALE, _SCALE_GRAD, SCALINGS, SUPPORTED_ACTS

# launches of the forward and backward kernels in this process, float32
# weights (rows 9, 10) and bf16 weights (rows 9b, 10b); callers may reset
# them to 0
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
LAUNCHES_FWD_BF16 = 0
LAUNCHES_BWD_BF16 = 0

MAX_HIDDEN = 256               # 8 warps of 4 n-tiles of 8 columns
SMEM_BYTES = 232_448           # the H100's opt-in shared memory per block
# bf16 instances: a block of 8 warps, RPW rows each
WARPS = 8
FWD_RPW = (8,)                 # rows per warp the kernels are built for
BWD_RPW = (4, 2)
SLICE_K, STAGES = 8, 3         # the weight stage: 3 slices of 8 f32 rows' bytes
# f32 instances (csrc/step_f32.cuh): RT trajectories a block, the slots in
# groups of SG
F32_ROWS = (64, 32, 16)
F32_BK, F32_STAGES = 8, 3      # the weight stage: 3 slices of 8 f32 rows
# use_pallas="auto" takes the kernels on the card only at the one shape the
# H100 A/B of the scaled recipe had them ahead of the composed path (PERF.md,
# section 6): separate networks, (H, N, L, d_x, d_y, K) as below, and at least
# 4,096 batch rows (the grid is ceil(B / 64) x Kn blocks, each walking its
# slots in turn).  No other shape was measured.
AUTO_SHAPE_H100 = (256, 2, 1, 1, 1, 2)
AUTO_MIN_BATCH_H100 = 4096
# the compute dtypes "auto" takes the kernels in at that shape: float32, and
# bfloat16, whose kernels (rows 9b-10b) the H100 A/B of the bf16 recipe had
# ahead of the composed bf16 path in every turn (PERF.md, section 6)
AUTO_COMPUTE_DTYPES_H100 = (None, torch.bfloat16)


class StepLayout:
    """Planes and rows of (W, V) for one config (``fused_step.py:135-187``).

    Planes (Kn, n_mats, H, H), (in, out): J_1..J_L (jump hidden layers),
    O_0..O_{L-1} (readout hidden layers), W1h (the h rows of the ODEFunc's
    first layer), Wmid_1..Wmid_{L-1}, Wlast.  Rows (Kn, n_rows, H): j1[d_x],
    bj[0..L], w1x[d_x], w1t, w1d, ode_b[0..L], bo[0..L-1], o2 (d_y rows per
    network; shared: K d_y rows, column order c = d K + k).
    """

    def __init__(self, n_hidden_layers: int, input_dim: int, output_dim: int,
                 num_moments: int, shared: bool):
        L, d_x, d_y, K = n_hidden_layers, input_dim, output_dim, num_moments
        self.L, self.d_x, self.d_y, self.K = L, d_x, d_y, K
        self.shared = bool(shared)
        self.Kn = 1 if shared else K
        self.mat_jump = list(range(0, L))
        self.mat_out = list(range(L, 2 * L))
        self.mat_w1h = 2 * L
        self.mat_ode_mid = list(range(2 * L + 1, 3 * L))
        self.mat_ode_last = 3 * L
        self.n_mats = 3 * L + 1
        r = 0
        self.row_j1 = r; r += d_x
        self.row_bj = list(range(r, r + L + 1)); r += L + 1
        self.row_w1x = r; r += d_x
        self.row_w1t = r; r += 1
        self.row_w1d = r; r += 1
        self.row_ode_b = list(range(r, r + L + 1)); r += L + 1
        self.row_bo = list(range(r, r + L)); r += L
        self.row_o2 = r
        self.n_o2 = K * d_y if shared else d_y
        self.n_rows = r + self.n_o2

    def o2_row(self, k: int, d: int) -> int:
        return self.row_o2 + (d * self.K + k if self.shared else d)

    def key(self) -> tuple:
        return (self.L, self.d_x, self.d_y, self.K, self.shared)


def fused_step_decline(input_dim: int, output_dim: int,
                       n_hidden_layers: int, activation: str,
                       dropout_rate: float, input_scaling: str, dt_ode_step,
                       ode_solver: str = "euler") -> Optional[str]:
    """The first reason the kernels do not compute this model, or None
    (canonical activation/scaling names expected)."""
    if dt_ode_step is not None:
        return "--dt-ode-step set (substep gaps ride the walk kernel)"
    if dropout_rate != 0.0:
        return "dropout unsupported"
    if ode_solver != "euler":
        return f"ode_solver {ode_solver!r} != euler"
    if activation not in SUPPORTED_ACTS or input_scaling not in _SCALE:
        return "activation/scaling has no kernel table"
    if min(input_dim, output_dim, n_hidden_layers) < 1:
        return "input_dim, output_dim and n_hidden_layers must be >= 1"
    return None


def fused_step_available(shared_network: bool, input_dim: int,
                         output_dim: int, n_hidden_layers: int,
                         activation: str, dropout_rate: float,
                         input_scaling: str, dt_ode_step,
                         ode_solver: str = "euler") -> bool:
    """Whether the kernels compute this model (``fused_step.py:190-202``,
    the JAX signature; canonical activation/scaling names expected).
    ``shared_network`` is unused: both modes are computed."""
    del shared_network
    return fused_step_decline(input_dim, output_dim, n_hidden_layers,
                              activation, dropout_rate, input_scaling,
                              dt_ode_step, ode_solver) is None


def _smem_floats(backward: bool, rt: int, H: int, N: int, L: int, d_x: int,
                 d_y: int, K: int) -> int:
    """Shared memory of one block of the bf16 instances, in floats
    (csrc/fused_step.cu's ``fwd_smem_floats`` / ``bwd_smem_floats``): the
    weight stage (each warp's strip of 3 slices of 16 bf16 rows by up to
    32 columns), and activation rows padded to ``act_stride`` floats, so
    the tensor cores' fragment loads are free of bank conflicts."""
    scal = rt * N * (2 * d_x + 1)                     # x, s(x), t
    stage = WARPS * STAGES * SLICE_K * 32
    HS = -(-H // 32) * 32 + 8                          # act_stride
    if not backward:
        return stage + 2 * rt * HS + scal
    return stage + (3 * L + 3) * rt * HS + scal + rt * (2 * N - 1) * d_y * K


def _f32_smem_floats(backward: bool, rt: int, sg: int, H: int, N: int,
                     d_x: int, d_y: int, K: int) -> int:
    """Shared memory of one block of the f32 instances, in floats
    (csrc/step_f32.cuh's ``smem_floats``): 80 floats of the stage's
    barriers and the block's constants, the weight stage, the group's
    buffer (H padded to 16 features of the group's rows, 4 floats apart
    more), and the tile's scalars."""
    Hp = -(-H // 16) * 16
    rows = min(2 * sg, 2 * N - 1) * rt
    f = 80 + F32_STAGES * F32_BK * Hp + Hp * (rows + 4) + rt * N * (2 * d_x + 1)
    return f + (rt * (2 * N - 1) * d_y * K if backward else 0)


def f32_plan(hidden_dim: int, n_slots: int, n_hidden_layers: int = 1,
             input_dim: int = 1, output_dim: int = 1, num_moments: int = 1
             ) -> Optional[tuple[tuple[int, int], tuple[int, int]]]:
    """(trajectories a tile, slots a group) of the f32 forward and backward
    on an H100: the first of ``F32_ROWS`` with a group that fits
    ``SMEM_BYTES``, and the most slots a group that fit; None where the
    shapes do not fit."""
    H, N, L = hidden_dim, n_slots, n_hidden_layers
    if not (1 <= H <= MAX_HIDDEN and N >= 1 and L >= 1 and input_dim >= 1
            and output_dim >= 1 and num_moments >= 1):
        return None
    plan = []
    for backward in (False, True):
        fit = [(rt, sg) for rt in F32_ROWS
               for sg in range(N, 0, -1)
               if 4 * _f32_smem_floats(backward, rt, sg, H, N, input_dim,
                                       output_dim, num_moments) <= SMEM_BYTES]
        if not fit:
            return None
        plan.append(fit[0])
    return plan[0], plan[1]


def kernel_plan(hidden_dim: int, n_slots: int, n_hidden_layers: int,
                input_dim: int, output_dim: int, num_moments: int,
                bf16: bool) -> Optional[tuple[tuple[int, int], tuple[int, int]]]:
    """(trajectories a tile, slots a group) of the forward and backward
    kernels, as ``njode_step_fwd`` / ``_bwd`` take them: the f32 instances'
    :func:`f32_plan`, or the bf16 instances' :func:`launch_plan` (8 RPW
    rows a tile, every slot in turn)."""
    args = (hidden_dim, n_slots, n_hidden_layers, input_dim, output_dim,
            num_moments)
    if not bf16:
        return f32_plan(*args)
    plan = launch_plan(*args)
    return None if plan is None else tuple((WARPS * r, n_slots) for r in plan)


def launch_plan(hidden_dim: int, n_slots: int, n_hidden_layers: int = 1,
                input_dim: int = 1, output_dim: int = 1,
                num_moments: int = 1) -> Optional[tuple[int, int]]:
    """Rows per warp (forward, backward) of the bf16 instances on an H100:
    the most of ``FWD_RPW`` / ``BWD_RPW`` whose block fits ``SMEM_BYTES``;
    None where the shapes do not fit."""
    H, N, L = hidden_dim, n_slots, n_hidden_layers
    if not (1 <= H <= MAX_HIDDEN and N >= 1 and L >= 1 and input_dim >= 1
            and output_dim >= 1 and num_moments >= 1):
        return None
    plan = []
    for backward, choices in ((False, FWD_RPW), (True, BWD_RPW)):
        fit = [r for r in choices if 4 * _smem_floats(
            backward, WARPS * r, H, N, L, input_dim, output_dim,
            num_moments) <= SMEM_BYTES]
        if not fit:
            return None
        plan.append(fit[0])
    return plan[0], plan[1]


def fused_step_fits(hidden_dim: int, n_slots: int, n_hidden_layers: int = 1,
                    input_dim: int = 1, output_dim: int = 1,
                    num_moments: int = 1) -> bool:
    """The port's shape gate: both kernels have a launch plan, in both
    instances."""
    args = (hidden_dim, n_slots, n_hidden_layers, input_dim, output_dim,
            num_moments)
    return launch_plan(*args) is not None and f32_plan(*args) is not None


# --------------------------------------------------------------------------
# packing: the model's modules <-> (W, V, bo2)
# --------------------------------------------------------------------------

def _networks(model):
    """[(jump, ode, out) Linear lists] per network (Kn of them)."""
    from ..models.mlp import linears
    if model.shared_network:
        nets = [(model.jump_nn, model.ode_func, model.output_nn)]
    else:
        nets = zip(model.jump_nns, model.ode_funcs, model.output_nns)
    return [tuple(linears(n) for n in trio) for trio in nets]


def pack_params(model) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The model's parameters -> (W (Kn, n_mats, H, H), V (Kn, n_rows, H),
    bo2 (K, d_y)), in differentiable torch ops.  torch's Linear weights are
    (out, in); the planes are (in, out), as in the JAX layout."""
    lo = layout_of(model)
    H, d_x, L = model.hidden_dim, model.input_dim, model.n_hidden_layers
    Ws, Vs = [], []
    for jl, ol, ul in _networks(model):
        mats = [None] * lo.n_mats
        for l in range(L):
            mats[lo.mat_jump[l]] = jl[l + 1].weight.t()
            mats[lo.mat_out[l]] = ul[l].weight.t()
        w1 = ol[0].weight                                   # (H, H + d_x + 2)
        mats[lo.mat_w1h] = w1[:, :H].t()
        for i, m in enumerate(lo.mat_ode_mid):
            mats[m] = ol[i + 1].weight.t()
        mats[lo.mat_ode_last] = ol[L].weight.t()
        rows = [None] * lo.n_rows
        for d in range(d_x):
            rows[lo.row_j1 + d] = jl[0].weight[:, d]
            rows[lo.row_w1x + d] = w1[:, H + d]
        rows[lo.row_w1t] = w1[:, H + d_x]
        rows[lo.row_w1d] = w1[:, H + d_x + 1]
        for l in range(L + 1):
            rows[lo.row_bj[l]] = jl[l].bias
            rows[lo.row_ode_b[l]] = ol[l].bias
        for l in range(L):
            rows[lo.row_bo[l]] = ul[l].bias
        for c in range(lo.n_o2):
            rows[lo.row_o2 + c] = ul[L].weight[c]
        Ws.append(torch.stack(mats))
        Vs.append(torch.stack(rows))
    if model.shared_network:
        # flat readout column c = d K + k -> (K, d_y)
        bo2 = _networks(model)[0][2][L].bias.reshape(lo.d_y, lo.K).t()
    else:
        bo2 = torch.stack([ul[L].bias for _, _, ul in _networks(model)])
    return torch.stack(Ws), torch.stack(Vs), bo2


def unpack_params(W, V, bo2, *, num_moments: int, hidden_dim: int,
                  shared_network: bool = False, input_dim: int = 1,
                  output_dim: int = 1, n_hidden_layers: int = 1
                  ) -> dict[str, torch.Tensor]:
    """Inverse of :func:`pack_params`: the port's state dict (the names of
    ``utils.weights.state_dict_from_jax``)."""
    lo = StepLayout(n_hidden_layers, input_dim, output_dim, num_moments,
                    shared_network)
    H, d_x, L = hidden_dim, input_dim, n_hidden_layers
    out: dict[str, torch.Tensor] = {}
    for kn in range(lo.Kn):
        w, v = W[kn], V[kn]
        names = (("jump_nn", "ode_func", "output_nn") if shared_network
                 else (f"jump_nns.{kn}", f"ode_funcs.{kn}",
                       f"output_nns.{kn}"))
        jump, ode, outn = names

        def put(prefix, l, weight, bias):
            out[f"{prefix}.net.{3 * l}.weight"] = weight.contiguous()
            out[f"{prefix}.net.{3 * l}.bias"] = bias.contiguous()
        put(jump, 0, torch.stack([v[lo.row_j1 + d] for d in range(d_x)], 1),
            v[lo.row_bj[0]])
        for l in range(L):
            put(jump, l + 1, w[lo.mat_jump[l]].t(), v[lo.row_bj[l + 1]])
            put(outn, l, w[lo.mat_out[l]].t(), v[lo.row_bo[l]])
        w1 = torch.cat([w[lo.mat_w1h].t()]
                       + [v[lo.row_w1x + d, :, None] for d in range(d_x)]
                       + [v[lo.row_w1t, :, None], v[lo.row_w1d, :, None]], 1)
        put(ode, 0, w1, v[lo.row_ode_b[0]])
        for i, m in enumerate(lo.mat_ode_mid):
            put(ode, i + 1, w[m].t(), v[lo.row_ode_b[i + 1]])
        put(ode, L, w[lo.mat_ode_last].t(), v[lo.row_ode_b[L]])
        o2 = v[lo.row_o2:lo.row_o2 + lo.n_o2]
        b = bo2.t().reshape(-1) if shared_network else bo2[kn]
        put(outn, L, o2, b)
    return out


def layout_of(model) -> StepLayout:
    """The model's layout: its networks' moments (this rank's block under
    the model axis's "moments")."""
    return StepLayout(model.n_hidden_layers, model.input_dim,
                      model.output_dim, model.local_moments,
                      model.shared_network)


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------

def _slot_major(times, values):
    """(B, N), (B, N, d_x) -> X (N B, d_x) and T (N, B), row s B + b."""
    B, N = times.shape
    return (values.transpose(0, 1).reshape(N * B, values.shape[-1]),
            times.t())


def _products(W, compute_dtype):
    """(W as the products read it, the rounding of an activation operand):
    float32 as given, or W cast to bf16 once and every operand rounded to
    bf16 at the product, in float32 arithmetic on bf16-exact values (the
    function of JAX's ``jnp.dot(a.astype(bf16), w_bf16,
    preferred_element_type=f32)``)."""
    if compute_dtype is None:
        return W, lambda a: a
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"fused step: no {compute_dtype} mode (float32 or "
                         "bfloat16)")
    return (W.to(torch.bfloat16).float(),
            lambda a: a.to(torch.bfloat16).float())


def _gy_rows(gy, kk: int, d: int):
    """(B, 2N-1, d_y, K) -> ((2N-1) B, 1), rows in the slot-major order of
    [HJ; HM]."""
    return gy[:, :, d, kk].t().reshape(-1, 1)


def fused_step_forward_reference(W, V, times, values, lo: StepLayout,
                                 act_name: str, scale_name: str,
                                 compute_dtype=None):
    """Plain PyTorch version of the forward kernel (the slot-batched
    ``_fwd_kernel``): Y (B, 2N-1, d_y, K), slots 0..N-1 the after-jump
    outputs, N..2N-2 the before-jump outputs of slots 1..N-1, bo2
    excluded.  ``compute_dtype=torch.bfloat16``: W and each product's
    activation operand rounded to bf16 (:func:`_products`).
    Differentiable."""
    A, SC = _ACT[act_name], _SCALE[scale_name]
    W, rd = _products(W, compute_dtype)
    B, N = times.shape
    S = N - 1
    X, T = _slot_major(times, values)
    cols = {}
    for kn in range(lo.Kn):
        w, v = W[kn], V[kn]
        pre = v[lo.row_bj[0]]
        for d in range(lo.d_x):
            pre = pre + X[:, d:d + 1] * v[lo.row_j1 + d]
        HJ = A(pre)
        for l in range(lo.L):
            HJ = A(rd(HJ) @ w[lo.mat_jump[l]] + v[lo.row_bj[l + 1]])
        U = HJ
        if S > 0:
            HJg = HJ[:S * B]
            T0 = T[:S].reshape(-1, 1)
            DT = (T[1:] - T[:-1]).reshape(-1, 1)
            BASE = T0 * v[lo.row_w1t] + DT * v[lo.row_w1d] + v[lo.row_ode_b[0]]
            for d in range(lo.d_x):
                BASE = BASE + SC(X[:S * B, d:d + 1]) * v[lo.row_w1x + d]
            G = A(rd(SC(HJg)) @ w[lo.mat_w1h] + BASE)
            for i, m in enumerate(lo.mat_ode_mid):
                G = A(rd(G) @ w[m] + v[lo.row_ode_b[i + 1]])
            DH = rd(G) @ w[lo.mat_ode_last] + v[lo.row_ode_b[lo.L]]
            U = torch.cat([HJ, HJg + DT * DH])
        for l in range(lo.L):
            U = A(rd(U) @ w[lo.mat_out[l]] + v[lo.row_bo[l]])
        for kk in (range(lo.K) if lo.shared else (kn,)):
            for d in range(lo.d_y):
                cols[d, kk] = (U @ v[lo.o2_row(kk, d)]).reshape(2 * N - 1, B).t()
    return torch.stack([torch.stack([cols[d, k] for k in range(lo.K)], -1)
                        for d in range(lo.d_y)], 2)


def fused_step_backward_reference(W, V, times, values, gy, lo: StepLayout,
                                  act_name: str, scale_name: str,
                                  compute_dtype=None):
    """Plain PyTorch version of the backward kernel (``_bwd_kernel``):
    rematerialize the forward, then the reverse chain; returns (dW, dV),
    the cotangents of W and V for the output cotangent gy (B, 2N-1, d_y,
    K), float32.  Sums over all rows of A^T G for every plane and column
    sums for every row of V: :func:`fused_step_records_reference`, then
    :func:`step_dw_reference`, the two passes of the f32 kernels.
    ``compute_dtype=torch.bfloat16``: the products as in the forward, g W^T
    with g rounded and A^T G with both rounded (``mm`` and ``outer`` of
    ``fused_step.py:336-346``)."""
    records, dV = fused_step_records_reference(W, V, times, values, gy, lo,
                                               act_name, scale_name,
                                               compute_dtype)
    return step_dw_reference(records, W.shape[-1], compute_dtype), dV


def step_dw_reference(records, hidden_dim: int, compute_dtype=None):
    """Plain version of the f32 backward's second pass: dW (Kn, n_mats, H,
    H) float32 from the records of :func:`fused_step_records_reference`,
    each plane's A^T G over all its rows (both rounded to bf16 under
    ``compute_dtype=torch.bfloat16``); a plane without records (the ODE's
    at N 1) gets zeros."""
    _, rd = _products(torch.zeros(()), compute_dtype)
    a0 = records[0][0][0]                 # the jump planes always have rows
    zero = a0.new_zeros(hidden_dim, hidden_dim)
    return torch.stack([torch.stack([
        zero if rec is None else rd(rec[0]).t() @ rd(rec[1])
        for rec in planes]) for planes in records]).to(torch.float32)


def fused_step_records_reference(W, V, times, values, gy, lo: StepLayout,
                                 act_name: str, scale_name: str,
                                 compute_dtype=None):
    """Plain version of the f32 backward's first pass: rematerialize the
    forward, then the reverse chain; returns (records, dV): records[kn][m]
    = (A, G), plane m's input rows and the cotangents of its pre-activation
    rows (None where the plane has no rows), and dV (Kn, n_rows, H), the
    cotangents of V for gy."""
    A, AG = _ACT[act_name], _ACT_GRAD[act_name]
    SC, SG = _SCALE[scale_name], _SCALE_GRAD[scale_name]
    B, N = times.shape
    S, L = N - 1, lo.L
    X, T = _slot_major(times, values)
    dV = torch.zeros_like(V)
    W, rd = _products(W, compute_dtype)
    records = [[None] * lo.n_mats for _ in range(lo.Kn)]
    for kn in range(lo.Kn):
        w, v, dv, rec = W[kn], V[kn], dV[kn], records[kn]
        # ---- rematerialize
        A_pre = [v[lo.row_bj[0]] + sum(X[:, d:d + 1] * v[lo.row_j1 + d]
                                       for d in range(lo.d_x))]
        A_val = [A(A_pre[0])]
        for l in range(L):
            A_pre.append(rd(A_val[l]) @ w[lo.mat_jump[l]]
                         + v[lo.row_bj[l + 1]])
            A_val.append(A(A_pre[l + 1]))
        HJ = A_val[L]
        if S > 0:
            HJg = HJ[:S * B]
            T0 = T[:S].reshape(-1, 1)
            DT = (T[1:] - T[:-1]).reshape(-1, 1)
            X_sc = [SC(X[:S * B, d:d + 1]) for d in range(lo.d_x)]
            HJ_sc = SC(HJg)
            BASE = T0 * v[lo.row_w1t] + DT * v[lo.row_w1d] + v[lo.row_ode_b[0]]
            for d in range(lo.d_x):
                BASE = BASE + X_sc[d] * v[lo.row_w1x + d]
            G_pre = [rd(HJ_sc) @ w[lo.mat_w1h] + BASE]
            G_val = [A(G_pre[0])]
            for i, m in enumerate(lo.mat_ode_mid):
                G_pre.append(rd(G_val[i]) @ w[m] + v[lo.row_ode_b[i + 1]])
                G_val.append(A(G_pre[i + 1]))
            DH = rd(G_val[L - 1]) @ w[lo.mat_ode_last] + v[lo.row_ode_b[L]]
            U_in = [torch.cat([HJ, HJg + DT * DH])]
        else:
            U_in = [HJ]
        U_pre = []
        for l in range(L):
            U_pre.append(rd(U_in[l]) @ w[lo.mat_out[l]] + v[lo.row_bo[l]])
            U_in.append(A(U_pre[l]))
        # ---- readout backward: dU sums GY o2 over the network's columns
        g = 0.0
        for kk in (range(lo.K) if lo.shared else (kn,)):
            for d in range(lo.d_y):
                GY = _gy_rows(gy, kk, d)
                dv[lo.o2_row(kk, d)] += (U_in[L] * GY).sum(0)
                g = g + GY * v[lo.o2_row(kk, d)]
        for l in range(L - 1, -1, -1):
            g_pre = g * AG(U_pre[l])
            rec[lo.mat_out[l]] = (U_in[l], g_pre)
            dv[lo.row_bo[l]] += g_pre.sum(0)
            g = rd(g_pre) @ w[lo.mat_out[l]].t()
        dHJ = g[:N * B]
        if S > 0:
            dHM = g[N * B:]
            g = DT * dHM
            rec[lo.mat_ode_last] = (G_val[L - 1], g)
            dv[lo.row_ode_b[L]] += g.sum(0)
            g = rd(g) @ w[lo.mat_ode_last].t()
            for i in range(L - 2, -1, -1):
                g_pre = g * AG(G_pre[i + 1])
                rec[lo.mat_ode_mid[i]] = (G_val[i], g_pre)
                dv[lo.row_ode_b[i + 1]] += g_pre.sum(0)
                g = rd(g_pre) @ w[lo.mat_ode_mid[i]].t()
            g = g * AG(G_pre[0])                          # dG1_pre
            rec[lo.mat_w1h] = (HJ_sc, g)
            for d in range(lo.d_x):
                dv[lo.row_w1x + d] += (X_sc[d] * g).sum(0)
            dv[lo.row_w1t] += (T0 * g).sum(0)
            dv[lo.row_w1d] += (DT * g).sum(0)
            dv[lo.row_ode_b[0]] += g.sum(0)
            dHJg = dHM + (rd(g) @ w[lo.mat_w1h].t()) * SG(HJg)
            dHJ = dHJ + torch.cat([dHJg, torch.zeros_like(dHJ[S * B:])])
        # ---- jump backward
        g = dHJ
        for l in range(L - 1, -1, -1):
            g_pre = g * AG(A_pre[l + 1])
            rec[lo.mat_jump[l]] = (A_val[l], g_pre)
            dv[lo.row_bj[l + 1]] += g_pre.sum(0)
            g = rd(g_pre) @ w[lo.mat_jump[l]].t()
        g = g * AG(A_pre[0])
        for d in range(lo.d_x):
            dv[lo.row_j1 + d] += (X[:, d:d + 1] * g).sum(0)
        dv[lo.row_bj[0]] += g.sum(0)
    return records, dV


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

@functools.cache
def _load_kernel():
    """Build (first call only) and bind ``njode_step_fwd``/``_bwd``."""
    from ._build import load
    lib = load("fused_step")
    P, I = ctypes.c_void_p, ctypes.c_int
    # x, t, W, V, Y | B N H L d_x d_y K shared act scale rows group bf16
    # | stream
    lib.njode_step_fwd.argtypes = [P] * 5 + [I] * 13 + [P]
    lib.njode_step_fwd.restype = I
    # B N H L d_x d_y K shared rows bf16
    lib.njode_step_scratch_floats.argtypes = [I] * 10
    lib.njode_step_scratch_floats.restype = ctypes.c_longlong
    # x, t, W, WT, V, gy, scratch, dW, dV | (as the forward) | stream
    lib.njode_step_bwd.argtypes = [P] * 9 + [I] * 13 + [P]
    lib.njode_step_bwd.restype = I
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _meta_ints(lo: StepLayout, B: int, N: int, H: int, act_name: str,
               scale_name: str) -> list[int]:
    return [B, N, H, lo.L, lo.d_x, lo.d_y, lo.K, int(lo.shared),
            SUPPORTED_ACTS.index(act_name), SCALINGS.index(scale_name)]


def _check_cuda(W, V, times, values, lo: StepLayout, act_name, scale_name):
    dev = W.device
    if dev.type != "cuda" or any(x.device != dev for x in (V, times, values)):
        raise ValueError(f"fused step: no kernel for device {dev} (or "
                         "tensors on mixed devices)")
    if act_name not in SUPPORTED_ACTS or scale_name not in _SCALE:
        raise ValueError(f"fused step: unsupported activation/scaling "
                         f"{act_name!r}/{scale_name!r}")
    if (W.dtype not in (torch.float32, torch.bfloat16)
            or any(x.dtype != torch.float32 for x in (V, times, values))):
        raise TypeError("fused step: the CUDA kernels take W in float32 or "
                        "bfloat16 and V, times and values in float32")
    B, N = times.shape
    H = W.shape[-1]
    if (W.shape != (lo.Kn, lo.n_mats, H, H) or V.shape != (lo.Kn, lo.n_rows, H)
            or values.shape != (B, N, lo.d_x)):
        raise ValueError(f"fused step: W {tuple(W.shape)}, V {tuple(V.shape)}"
                         f", values {tuple(values.shape)} do not match the "
                         f"layout {lo.key()}")
    plan = kernel_plan(H, N, lo.L, lo.d_x, lo.d_y, lo.K,
                       W.dtype == torch.bfloat16)
    if plan is None:
        raise ValueError(f"fused step: H={H}, N={N}, L={lo.L}, d_x={lo.d_x},"
                         f" d_y={lo.d_y}, K={lo.K} outside fused_step_fits")
    return plan


def _launch_fwd(W, V, times, values, lo, act_name, scale_name, plan):
    """Row 9 (W float32) or 9b (W bfloat16, the cast planes); plan: the
    forward's (trajectories a tile, slots a group) of :func:`kernel_plan`."""
    global LAUNCHES_FWD, LAUNCHES_FWD_BF16
    B, N = times.shape
    H = W.shape[-1]
    dev = W.device
    Y = torch.empty(B, 2 * N - 1, lo.d_y, lo.K, dtype=torch.float32,
                    device=dev)
    x, t = values.contiguous(), times.contiguous()
    Wc, Vc = W.contiguous(), V.contiguous()
    lib = _load_kernel()
    with torch.cuda.device(dev):
        err = lib.njode_step_fwd(
            x.data_ptr(), t.data_ptr(), Wc.data_ptr(), Vc.data_ptr(),
            Y.data_ptr(), *_meta_ints(lo, B, N, H, act_name, scale_name),
            *plan, int(W.dtype == torch.bfloat16), _stream(dev))
    from ._build import check
    check(lib, err, "njode_step_fwd launch")
    if W.dtype == torch.bfloat16:
        LAUNCHES_FWD_BF16 += 1
    else:
        LAUNCHES_FWD += 1
    return Y


def _launch_bwd(W, V, times, values, gy, lo, act_name, scale_name, plan):
    """Row 10 (W float32) or 10b (W bfloat16, the cast planes; WT their
    transpose); dW and dV come back in float32.  plan: the backward's
    (trajectories a tile, slots a group) of :func:`kernel_plan`."""
    global LAUNCHES_BWD, LAUNCHES_BWD_BF16
    B, N = times.shape
    H = W.shape[-1]
    dev = W.device
    x, t = values.contiguous(), times.contiguous()
    Wc, Vc = W.contiguous(), V.contiguous()
    WT = Wc.transpose(-1, -2).contiguous()
    gyc = gy.contiguous()
    meta = _meta_ints(lo, B, N, H, act_name, scale_name)
    lib = _load_kernel()
    bf16 = int(W.dtype == torch.bfloat16)
    scratch = torch.empty(int(lib.njode_step_scratch_floats(
        B, N, H, lo.L, lo.d_x, lo.d_y, lo.K, int(lo.shared), plan[0], bf16)),
        dtype=torch.float32, device=dev)
    dW = torch.empty_like(Wc, dtype=torch.float32)
    dV = torch.empty_like(Vc)
    with torch.cuda.device(dev):
        err = lib.njode_step_bwd(
            x.data_ptr(), t.data_ptr(), Wc.data_ptr(), WT.data_ptr(),
            Vc.data_ptr(), gyc.data_ptr(), scratch.data_ptr(), dW.data_ptr(),
            dV.data_ptr(), *meta, *plan, bf16, _stream(dev))
    from ._build import check
    check(lib, err, "njode_step_bwd launch")
    if W.dtype == torch.bfloat16:
        LAUNCHES_BWD_BF16 += 1
    else:
        LAUNCHES_BWD += 1
    return dW, dV


class FusedStep(torch.autograd.Function):
    """Rows 9 and 10 (9b and 10b under ``compute_dtype=torch.bfloat16``)
    as one differentiable op: (W, V) -> Y (B, 2N-1, d_y, K).  CPU tensors
    take the plain versions (the explicit backward, not autograd through
    the forward), CUDA tensors the kernels.  In bf16 W is cast once here,
    as the JAX ``core_fwd`` does, and the backward runs on the cast planes;
    dW comes back in float32.  Times and values get no cotangent."""

    @staticmethod
    def forward(ctx, W, V, times, values, lo, act_name, scale_name,
                compute_dtype=None):
        if all(x.device.type == "cpu" for x in (W, V, times, values)):
            plan = None
            Y = fused_step_forward_reference(W, V, times, values, lo,
                                             act_name, scale_name,
                                             compute_dtype)
        else:
            if compute_dtype is not None:   # _check_cuda refuses all but bf16
                W = W.to(compute_dtype)
            plan = _check_cuda(W, V, times, values, lo, act_name, scale_name)
            Y = _launch_fwd(W, V, times, values, lo, act_name, scale_name,
                            plan[0])
        ctx.save_for_backward(W, V, times, values)
        ctx.meta = (lo, act_name, scale_name, plan, compute_dtype)
        return Y

    @staticmethod
    def backward(ctx, gy):
        W, V, times, values = ctx.saved_tensors
        lo, act_name, scale_name, plan, compute_dtype = ctx.meta
        if plan is None:
            dW, dV = fused_step_backward_reference(W, V, times, values, gy,
                                                   lo, act_name, scale_name,
                                                   compute_dtype)
        else:
            dW, dV = _launch_bwd(W, V, times, values, gy, lo, act_name,
                                 scale_name, plan[1])
        return dW, dV, None, None, None, None, None, None


def fused_step_apply_packed(W, V, bo2, times, values, *, num_moments: int,
                            activation: str, input_scaling: str,
                            shared_network: bool = False, input_dim: int = 1,
                            output_dim: int = 1, n_hidden_layers: int = 1,
                            compute_dtype=None):
    """The fused forward of ``NeuralJumpODE.apply`` on packed (W, V, bo2)
    (:func:`pack_params`): times (B, N), values (B, N, d_x) -> (preds,
    preds_before), each (B, N, d_y, K); preds_before[:, 0] is 0.  The
    kernels for CUDA tensors, the plain versions for CPU tensors; an error
    otherwise.  ``compute_dtype``: None (float32) or ``torch.bfloat16``.
    Differentiable in (W, V, bo2)."""
    lo = StepLayout(n_hidden_layers, input_dim, output_dim, num_moments,
                    shared_network)
    B, N = times.shape
    Y = FusedStep.apply(W, V, times, values, lo, activation, input_scaling,
                        compute_dtype)
    bias = bo2.t()                                       # (d_y, K)
    preds = Y[:, :N] + bias
    if N == 1:
        return preds, torch.zeros_like(preds)
    first = torch.zeros_like(preds[:, :1])
    return preds, torch.cat([first, Y[:, N:] + bias], dim=1)


def fused_step_loss_packed(W, V, bo2, times, values, mask=None, *,
                           num_moments: int, activation: str,
                           input_scaling: str,
                           ignore_first_continuity: bool = False,
                           moment_weights=None, eps: float = 1e-10,
                           variance_method: str = "direct", traj_mask=None,
                           extended_moments: bool = False,
                           shared_network: bool = False, input_dim: int = 1,
                           output_dim: int = 1, n_hidden_layers: int = 1,
                           compute_dtype=None):
    """``nj_ode_loss_dense(values, *fused_step_apply_packed(...), mask,
    ...)``:
    the value and gradients of the JAX lane-space loss, without its
    selector-matmul glue.  Needs output_dim == input_dim."""
    if output_dim != input_dim:
        raise ValueError("fused_step_loss needs output_dim == input_dim "
                         f"(got {output_dim} != {input_dim})")
    from ..models.loss import nj_ode_loss_dense
    preds, preds_before = fused_step_apply_packed(
        W, V, bo2, times, values, num_moments=num_moments,
        activation=activation, input_scaling=input_scaling,
        shared_network=shared_network, input_dim=input_dim,
        output_dim=output_dim, n_hidden_layers=n_hidden_layers,
        compute_dtype=compute_dtype)
    return nj_ode_loss_dense(
        values, preds, preds_before, mask,
        ignore_first_continuity=ignore_first_continuity,
        moment_weights=moment_weights, eps=eps,
        variance_method=variance_method, traj_mask=traj_mask,
        extended_moments=extended_moments)


def _model_kwargs(model, compute_dtype) -> dict:
    kw = model._step_kwargs()
    if compute_dtype is not None:
        kw["compute_dtype"] = compute_dtype
    return kw


def fused_step_apply(model, times, values, *, compute_dtype=None):
    """The fused forward of ``model.apply`` (``fused_step.py:932``): packs
    the model's parameters (:func:`pack_params`), then
    :func:`fused_step_apply_packed` with the model's configuration.  The
    port's parameters live in the module, so the model takes the place of
    the JAX pytree and its hyperparameters; ``compute_dtype`` None means
    the model's.  Differentiable in the model's parameters."""
    return fused_step_apply_packed(*pack_params(model), times, values,
                                   **_model_kwargs(model, compute_dtype))


def fused_step_loss(model, times, values, mask=None, *,
                    ignore_first_continuity: bool = False,
                    moment_weights=None, eps: float = 1e-10,
                    variance_method: str = "direct", traj_mask=None,
                    extended_moments: bool = False, compute_dtype=None):
    """The fused loss on the model's parameters (``fused_step.py:904``):
    packs them, then :func:`fused_step_loss_packed`."""
    return fused_step_loss_packed(
        *pack_params(model), times, values, mask,
        ignore_first_continuity=ignore_first_continuity,
        moment_weights=moment_weights, eps=eps,
        variance_method=variance_method, traj_mask=traj_mask,
        extended_moments=extended_moments,
        **_model_kwargs(model, compute_dtype))
