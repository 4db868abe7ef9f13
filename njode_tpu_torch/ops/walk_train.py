"""The production training run in one CUDA kernel: every Adam step of an
epoch of the shared-network grid-walk model.

Port of ``njode_tpu/ops/walk_train.py``.  The production recipe
(``scripts/run_black_scholes.sh``: hidden 50, ``--shared-network``, two
moments, ``--dt-ode-step 0.01``, batch 256) trains on the grid walk; this
kernel runs all of an epoch's steps in one launch: the jump network, the
forward walk, both readouts, the closed-form loss gradient, the backward
walk, the jump backward and Adam, with euler, heun or rk4.

Kernel: ``csrc/walk_train.cu`` (``njode_walk_train_run``), which replaces
the TPU kernel ``walk_train.py:178`` ``_walk_train_kernel``.  A group of 1-4
warps walks each trajectory, splitting its products, with no block barrier
inside the walk; the backward walk writes the operands of the
weight-gradient sums to a step buffer, which the whole grid reduces after a
grid barrier, applying Adam to each entry it sums; see the source for the
design.

Scope, as the JAX package's (:func:`walk_train_available`): shared network,
d_x = d_y = 1, one hidden layer, no dropout, ``dt_ode_step`` set, euler,
heun or rk4, any activation and input scaling, K in {1, 2} moments,
``ignore_first_continuity``, every observation time on the grid (the
caller's ``grid_walk`` promise) and a full observation mask.  The port's own
gate on the shapes (:func:`walk_train_shapes_ok`): 1 <= H <= 128, N >= 2,
1 <= batch <= 1,024 (every block resident at once), every solver; the
block's shared memory on the H100 and the step buffer's chunk are
:func:`launch_plan`'s.  The JAX package's TPU budgets
(``batch % (8 nh)``, ``batch <= 256``, ``_VMEM_ROWS_MAX``, ``_ring_plan``)
are not copied.

Layout of the train state (:class:`WalkState`), float32: ``params``, ``m``,
``v`` (P,) hold the model's parameters in the order and orientation of its
``named_parameters()`` (:func:`param_shapes`); ``stat`` (2,) the Adam
bias-correction powers [b1^t, b2^t].  Data: the rows of
:func:`njode_tpu_torch.ops.pack_minibatches`.

``mxu_dtype="bfloat16"`` (the JAX kernel's ``mxu``, ``walk_train.py:213``)
rounds both operands of every product to bf16 and sums in f32, at the JAX
walk's own points: the walk folds [scaled state, scaled x, stage time, 1]
into one product with [W1h; w1x; w1t; cvec] (cvec = t_elapsed w1_tel + b1
rounded once, after it is formed) and [hidden, 1] into one with [W2; b2],
so those columns, and the gradients of b1, w1_tel, b2, w1x and w1t, take
rounded factors too; the jump's J2 and the readout's O1 products round as
well.  The readout's o2, every other bias gradient, parameters, Adam state
and the loss stay f32.

Wrapper: :func:`fused_walk_train_run` launches the kernel for CUDA tensors
and takes its plain version :func:`fused_walk_train_run_reference` only for
CPU tensors.  :func:`init_walk_state`, :func:`walk_state_from`,
:func:`optax_state_into_walk` and :func:`walk_train_params` map between the
train state and the model's ``state_dict`` and ``torch.optim.Adam``'s.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..models.loss import nj_ode_loss_dense
from .activations import _ACT, _SCALE, SCALINGS, SUPPORTED_ACTS
from .train_kernel import MXU_DTYPES, _adam_math, _bf16_round
from .walk_scan import walk_cells

# launches of the CUDA kernel in this process, by mode (f32, and the bf16
# products of mxu_dtype="bfloat16"); callers may reset them to 0
LAUNCHES = 0
LAUNCHES_BF16 = 0

MAX_HIDDEN = 128
MAX_BATCH = 1024
MAX_WARPS = 8
# blocks the minibatch is spread over: one an SM of the H100's 132
TARGET_BLOCKS = 128
# the H100's shared memory a block may opt into, less a margin
SMEM_BYTES = 232448 - 128
# the cap of the step buffer (the backward walk's records of a chunk of
# cells), so that it stays in the 50 MB L2 beside the walk's residuals
STEP_BUFFER_BYTES = 24 << 20
TILE = 64  # floats of a gradient tile's row of shared memory, a warp

# Explicit Runge-Kutta tableaux, as the JAX package's (walk_train.py:118):
# per stage ((a_ij on earlier stages' k), c_i in dt units), then the weights
# b_i.  Euler is the one-stage identity tableau.
_TABLEAU = {
    "euler": ((((), 0.0),), (1.0,)),
    "heun": ((((), 0.0), (((0, 1.0),), 1.0)), (0.5, 0.5)),
    "rk4": ((((), 0.0), (((0, 0.5),), 0.5), (((1, 0.5),), 0.5),
             (((2, 1.0),), 1.0)), (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0,
                                   1.0 / 6.0)),
}


class WalkState(NamedTuple):
    params: torch.Tensor   # (P,)
    m: torch.Tensor        # (P,)
    v: torch.Tensor        # (P,)
    stat: torch.Tensor     # (2,) [b1^t, b2^t]


def walk_train_available(shared_network, input_dim, output_dim,
                         n_hidden_layers, activation, dropout_rate,
                         input_scaling, dt_ode_step,
                         ode_solver="euler") -> bool:
    """Whether the kernel computes this model configuration (the JAX
    package's scope, ``njode_tpu/ops/walk_train.py:147``); grid alignment
    is the caller's promise."""
    return (bool(shared_network) and input_dim == 1 and output_dim == 1
            and n_hidden_layers == 1 and dropout_rate == 0.0
            and dt_ode_step is not None and ode_solver in _TABLEAU
            and activation in _ACT and input_scaling in _SCALE)


class WalkPlan(NamedTuple):
    warps: int          # warps a block
    wpt: int            # warps a trajectory, splitting each product's rows
    blocks: int         # blocks of the cooperative launch
    four: bool          # O1 in a plane of its own (else it takes J2's turn)
    smem_bytes: int     # the block's dynamic shared memory
    chunk: int          # cells of the backward walk a step-buffer pass holds
    buffer_bytes: int   # the step buffer of one chunk


def _smem_floats(H: int, warps: int, four: bool) -> int:
    """The block's shared memory (``smem_floats`` in the source): W1h, W2,
    J2 and, with ``four``, O1, each (in, out) in a zero-padded plane of
    HP x (HP + 1) floats, HP = 64 up to H 64 and 128 beyond (32 rows a
    lane's column), a gradient tile and two partial products a warp."""
    hp = 64 if H <= 64 else 128
    return (4 if four else 3) * hp * (hp + 1) + warps * (TILE + 2 * hp)


def _record_floats(H: int) -> int:
    """Step-buffer floats of one (trajectory, cell, stage): the scaled
    stage input with [x, t, 1], the hidden activation with [1], the
    pre-activation cotangent and the stage cotangent."""
    return (H + 3) + (H + 1) + 2 * H


def launch_plan(hidden_dim: int, batch_size: int, n_slots: int = 10,
                ode_solver: str = "euler",
                max_substeps: Optional[int] = None) -> Optional[WalkPlan]:
    """The kernel's launch plan on an H100, or None where the shapes do not
    fit.  ceil(batch / 128) trajectories a block (1-8), so the minibatch
    spreads over up to 128 SMs; each trajectory's products split over 4
    warps where the block then holds at most 8 (batch <= 256), 2 up to
    batch 512, else 1; O1 gets a plane of its own in shared memory where
    four planes fit; the backward walk's step buffer holds as many cells as
    ``STEP_BUFFER_BYTES`` allows (all ``max_substeps`` where given and
    they fit)."""
    H, BS, N = int(hidden_dim), int(batch_size), int(n_slots)
    if not (1 <= H <= MAX_HIDDEN and 1 <= BS <= MAX_BATCH and N >= 2
            and ode_solver in _TABLEAU):
        return None
    n_st = len(_TABLEAU[ode_solver][0])
    tpb = -(-BS // TARGET_BLOCKS)
    wpt = 4 if tpb <= 2 else (2 if tpb <= 4 else 1)
    warps = tpb * wpt
    blocks = -(-BS // tpb)
    four = 4 * _smem_floats(H, warps, True) <= SMEM_BYTES
    smem = 4 * _smem_floats(H, warps, four)
    if smem > SMEM_BYTES:
        return None
    per_cell = 4 * BS * n_st * _record_floats(H)
    chunk = max(1, STEP_BUFFER_BYTES // per_cell)
    if max_substeps is not None:
        chunk = min(chunk, max(1, int(max_substeps)))
    return WalkPlan(warps, wpt, blocks, four, smem, chunk, chunk * per_cell)


def walk_train_shapes_ok(hidden_dim: int, batch_size, n_slots: int,
                         max_substeps: int, ode_solver: str = "euler") -> bool:
    """The port's shape gate (counterpart of the JAX
    ``walk_train_shapes_ok``, with the H100's limits)."""
    if batch_size is None or n_slots is None or max_substeps < 1:
        return False
    return launch_plan(hidden_dim, batch_size, n_slots,
                       ode_solver) is not None


# --------------------------------------------------------------------------
# layout: model / optimizer state <-> train state
# --------------------------------------------------------------------------

def param_shapes(hidden_dim: int, num_moments: int) -> list[tuple[str, tuple]]:
    """(state-dict name, shape) of the shared-network model's parameters, in
    the order of ``named_parameters()`` and of the flat train state."""
    H, K = hidden_dim, num_moments
    return [("jump_nn.net.0.weight", (H, 1)), ("jump_nn.net.0.bias", (H,)),
            ("jump_nn.net.3.weight", (H, H)), ("jump_nn.net.3.bias", (H,)),
            ("ode_func.net.0.weight", (H, H + 3)),
            ("ode_func.net.0.bias", (H,)),
            ("ode_func.net.3.weight", (H, H)), ("ode_func.net.3.bias", (H,)),
            ("output_nn.net.0.weight", (H, H)),
            ("output_nn.net.0.bias", (H,)),
            ("output_nn.net.3.weight", (K, H)),
            ("output_nn.net.3.bias", (K,))]


def n_params(hidden_dim: int, num_moments: int) -> int:
    return sum(math.prod(s) for _, s in param_shapes(hidden_dim, num_moments))


def _pack(sd: dict, H: int, K: int) -> torch.Tensor:
    return torch.cat([sd[n].reshape(-1).to(torch.float32)
                      for n, _ in param_shapes(H, K)]).contiguous()


def _unpack(flat: torch.Tensor, H: int, K: int) -> dict:
    out, i = {}, 0
    for name, shape in param_shapes(H, K):
        n = math.prod(shape)
        out[name] = flat[i:i + n].reshape(shape).contiguous()
        i += n
    return out


def _powers(step: float, betas, device) -> torch.Tensor:
    b = torch.tensor(betas, dtype=torch.float32, device=device)
    return b ** torch.tensor(float(step), dtype=torch.float32, device=device)


def init_walk_state(model) -> WalkState:
    """The model's parameters with fresh Adam moments and powers [1, 1]."""
    p = _pack(model.state_dict(), model.hidden_dim, model.num_moments)
    z = torch.zeros_like(p)
    return WalkState(p, z, z.clone(),
                     torch.ones(2, dtype=torch.float32, device=p.device))


def walk_train_params(state: WalkState, hidden_dim: int,
                      num_moments: int) -> dict:
    """The model ``state_dict`` entries a train state holds (counterpart of
    the JAX ``unpack_walk_params``)."""
    return _unpack(state.params, hidden_dim, num_moments)


def walk_state_from(model, opt_state_dict: dict,
                    betas=(0.9, 0.999)) -> WalkState:
    """(model, ``torch.optim.Adam.state_dict()``) -> the train state, the
    powers from the step count: a kernel run resumes exactly where the
    composed trainer stopped (counterpart of the JAX ``walk_state_from``)."""
    H, K = model.hidden_dim, model.num_moments
    names = [n for n, _ in model.named_parameters()]
    params = _pack(model.state_dict(), H, K)
    state = opt_state_dict.get("state", {})
    if not state:
        z = torch.zeros_like(params)
        return WalkState(params, z, z.clone(),
                         _powers(0, betas, params.device))
    per = {names[i]: s for i, s in state.items()}
    steps = {float(s["step"]) for s in per.values()}
    if len(per) != len(names) or len(steps) != 1:
        raise ValueError("walk-train kernel: the Adam state must cover every "
                         "parameter with one step count")
    dev = params.device
    m = _pack({n: s["exp_avg"].to(dev) for n, s in per.items()}, H, K)
    v = _pack({n: s["exp_avg_sq"].to(dev) for n, s in per.items()}, H, K)
    return WalkState(params, m, v, _powers(steps.pop(), betas, dev))


def optax_state_into_walk(state: WalkState, n_steps: int,
                          opt_state_dict: dict, model) -> tuple[dict, dict]:
    """Train state after ``n_steps`` more steps -> (model ``state_dict``,
    ``torch.optim.Adam`` ``state_dict``), step counts advanced by
    ``n_steps`` and the param groups kept (counterpart of the JAX
    ``optax_state_into_walk``)."""
    H, K = model.hidden_dim, model.num_moments
    names = [n for n, _ in model.named_parameters()]
    m, v = _unpack(state.m, H, K), _unpack(state.v, H, K)
    old = opt_state_dict.get("state", {})
    step = float(old[0]["step"]) if old else 0.0
    new_state = {
        i: {"step": torch.tensor(step + n_steps, dtype=torch.float32),
            "exp_avg": m[n], "exp_avg_sq": v[n]}
        for i, n in enumerate(names)}
    sd = dict(model.state_dict())
    sd.update(_unpack(state.params, H, K))
    return sd, {"state": new_state,
                "param_groups": opt_state_dict["param_groups"]}


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

class RoundedMM(torch.autograd.Function):
    """a @ w with both operands rounded to bf16 and the sums in a's dtype,
    and the backward of the JAX kernel's ``mmT`` and ``outer``: the
    cotangent g rounded too, ga = r(g) r(w)^T, gw = r(a)^T r(g) summed over
    a's leading dimensions (the cast itself passes g straight through)."""

    @staticmethod
    def forward(ctx, a, w):
        ra, rw = _bf16_round(a), _bf16_round(w)
        ctx.save_for_backward(ra, rw)
        return torch.matmul(ra, rw)

    @staticmethod
    def backward(ctx, g):
        ra, rw = ctx.saved_tensors
        rg = _bf16_round(g)
        gw = torch.matmul(ra.reshape(-1, ra.shape[-1]).t(),
                          rg.reshape(-1, rg.shape[-1]))
        return torch.matmul(rg, rw.t()), gw


def _mm(bf16: bool):
    return RoundedMM.apply if bf16 else torch.matmul


def walk_train_forward(w: dict, x: torch.Tensor, t: torch.Tensor, *,
                       dt: float, M: int, activation: str,
                       input_scaling: str, ode_solver: str,
                       mxu_dtype: str = "float32"):
    """The kernel's forward of one minibatch in plain PyTorch,
    differentiable in ``w`` (state-dict entries): x, t (BS, N) ->
    (preds, preds_before), each (BS, N, 1, K).  The walk's arithmetic is
    the kernel's: cell floor(t (1/dt) + 0.5), t_elapsed = dt inside the
    bias for euler and 0 for the stages of heun and rk4.  Under
    ``mxu_dtype="bfloat16"`` each product is a :class:`RoundedMM` over the
    JAX walk's operands (the module's docstring)."""
    A, SC = _ACT[activation], _SCALE[input_scaling]
    bf16 = mxu_dtype == "bfloat16"
    mm = _mm(bf16)
    BS, N = x.shape
    H = w["jump_nn.net.3.bias"].shape[0]
    a1 = A(x[..., None] * w["jump_nn.net.0.weight"][:, 0]
           + w["jump_nn.net.0.bias"])
    hj = A(mm(a1, w["jump_nn.net.3.weight"].t())
           + w["jump_nn.net.3.bias"])                          # (BS, N, H)
    W1 = w["ode_func.net.0.weight"]
    w1h, w1x, w1t, w1tel = W1[:, :H].t(), W1[:, H], W1[:, H + 1], W1[:, H + 2]
    w2, b2 = w["ode_func.net.3.weight"].t(), w["ode_func.net.3.bias"]
    stages, bweights = _TABLEAU[ode_solver]
    tel = dt if ode_solver == "euler" else 0.0
    cvec = (tel * w1tel + w["ode_func.net.0.bias"] if tel
            else w["ode_func.net.0.bias"])
    if bf16:   # the walk's two products, their bias rows folded in
        w1eff = torch.cat([w1h, w1x[None], w1t[None], cvec[None]])
        w2eff = torch.cat([w2, b2[None]])
    inv_dt = float(torch.tensor(1.0 / dt, dtype=torch.float32))
    cells = torch.floor(t * inv_dt + 0.5).long()

    def solver_step(h, x, tt):
        ks = []
        for aij, ci in stages:
            s_in = h
            for j, a in aij:
                s_in = s_in + (dt * a) * ks[j]
            ts = tt + dt * ci if ci else tt
            if bf16:
                lead = s_in.shape[:-1] + (1,)
                pre = mm(torch.cat([SC(s_in), x.expand(lead),
                                    ts[:, None].expand(lead),
                                    s_in.new_ones(lead)], -1), w1eff)
                hid = A(pre)
                ks.append(mm(torch.cat([hid, hid.new_ones(lead)], -1),
                             w2eff))
                continue
            pre = (torch.matmul(SC(s_in), w1h) + x * w1x
                   + ts[:, None] * w1t + cvec)
            ks.append(torch.matmul(A(pre), w2) + b2)
        acc = ks[0] if bweights[0] == 1.0 else bweights[0] * ks[0]
        for i in range(1, len(ks)):
            acc = acc + (ks[i] if bweights[i] == 1.0 else bweights[i] * ks[i])
        return h + dt * acc

    hm = walk_cells(hj[None], SC(x)[..., None], t, cells, cells.clamp(0, M),
                    M, dt, solver_step)[0]                    # (BS, N-1, H)
    c = cells[:, 1:]
    hm = torch.where(((c >= 0) & (c <= M))[..., None], hm, 0.0)
    inp = torch.cat([hj, hm], 1)                              # (BS, 2N-1, H)
    u = A(mm(inp, w["output_nn.net.0.weight"].t())
          + w["output_nn.net.0.bias"])
    y = (torch.matmul(u, w["output_nn.net.3.weight"].t())
         + w["output_nn.net.3.bias"])                         # (BS, 2N-1, K)
    preds = y[:, :N, None, :]
    before = torch.cat([torch.zeros_like(y[:, :1]), y[:, N:]], 1)[:, :, None]
    return preds, before


def _check_args(num_moments, activation, input_scaling, batch_size, data,
                n_slots, variance_method, ode_solver, mxu_dtype):
    if mxu_dtype not in MXU_DTYPES:
        raise ValueError(f"walk-train kernel: mxu_dtype={mxu_dtype!r} must "
                         "be 'float32' or 'bfloat16'")
    if ode_solver not in _TABLEAU:
        raise ValueError(f"walk-train kernel: unknown ode_solver "
                         f"{ode_solver!r} (one of {sorted(_TABLEAU)})")
    if num_moments not in (1, 2):
        raise ValueError("walk-train kernel: K in (1, 2) moments only")
    if activation not in SUPPORTED_ACTS or input_scaling not in SCALINGS:
        raise ValueError(f"walk-train kernel: unsupported activation/scaling "
                         f"{activation!r}/{input_scaling!r}")
    if variance_method not in ("direct", "second_moment"):
        raise ValueError(f"Unknown variance_method: {variance_method}")
    if batch_size is None or int(batch_size) < 1:
        raise ValueError(f"walk-train kernel: batch_size {batch_size} must "
                         "be a positive integer")
    if data.ndim != 2 or data.shape[1] != 2 * n_slots + 1 or n_slots < 2:
        raise ValueError(f"walk-train kernel: data has shape "
                         f"{tuple(data.shape)}, expected (rows, "
                         f"{2 * n_slots + 1}) with n_slots >= 2")
    if data.shape[0] % batch_size:
        raise ValueError("walk-train kernel: data rows must be a whole "
                         "number of minibatches")


def fused_walk_train_run_reference(state: WalkState, data: torch.Tensor, *,
                                   n_slots: int, num_moments: int,
                                   batch_size: int, hidden_dim: int,
                                   dt_ode_step: float, max_substeps: int,
                                   activation: str = "relu",
                                   input_scaling: str = "identity",
                                   lr: float = 1e-3,
                                   weight_decay: float = 0.0,
                                   moment_weights=(1.0, 10.0),
                                   eps: float = 1e-10,
                                   variance_method: str = "direct",
                                   betas=(0.9, 0.999), adam_eps: float = 1e-8,
                                   ode_solver: str = "euler",
                                   mxu_dtype: str = "float32"):
    """Plain PyTorch version of the kernel, on any device, checked
    independently of the kernel's hand-derived backward: per step
    :func:`walk_train_forward`, ``nj_ode_loss_dense`` with the trajectory
    mask and ``ignore_first_continuity``, ``torch.autograd.grad`` and
    torch-style Adam.  Same arguments and result as
    :func:`fused_walk_train_run`.  A float64 state and data run it in
    float64, with the same bf16 rounding points."""
    _check_args(num_moments, activation, input_scaling, batch_size, data,
                n_slots, variance_method, ode_solver, mxu_dtype)
    H, K, N, BS = hidden_dim, num_moments, n_slots, batch_size
    mw = [float(w) for w in moment_weights][:K]
    b1, b2 = float(betas[0]), float(betas[1])
    params, m, v = (x.clone() for x in state[:3])
    c1, c2 = state.stat[0].clone(), state.stat[1].clone()
    adam = dict(lr=lr, wd=weight_decay, b1=b1, b2=b2, eps_adam=adam_eps)
    losses = []
    for g in range(data.shape[0] // BS):
        rows = data[g * BS:(g + 1) * BS]
        x, t, valid = rows[:, :N], rows[:, N:2 * N], rows[:, 2 * N]
        c1, c2 = c1 * b1, c2 * b2
        with torch.enable_grad():
            w = {n: p.detach().requires_grad_()
                 for n, p in _unpack(params, H, K).items()}
            preds, before = walk_train_forward(
                w, x, t, dt=float(dt_ode_step), M=int(max_substeps),
                activation=activation, input_scaling=input_scaling,
                ode_solver=ode_solver, mxu_dtype=mxu_dtype)
            L = nj_ode_loss_dense(x[..., None], preds, before, None,
                                  ignore_first_continuity=True,
                                  moment_weights=mw, eps=eps,
                                  variance_method=variance_method,
                                  traj_mask=valid > 0)
            grads = torch.autograd.grad(L, list(w.values()))
        grad = torch.cat([gr.reshape(-1) for gr in grads])
        params, m, v = _adam_math(params, m, v, grad, c1=c1, c2=c2, **adam)
        losses.append(L.detach())
    loss = (torch.stack(losses) if losses
            else torch.zeros(0, device=data.device))
    return WalkState(params, m, v, torch.stack([c1, c2])), loss


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

@functools.cache
def _load_kernel():
    """Build (first call only) and bind ``njode_walk_train_run``."""
    from ._build import load
    lib = load("walk_train")
    P = ctypes.c_void_p
    lib.njode_walk_train_run.argtypes = (
        [P] * 7 + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, P])
    lib.njode_walk_train_run.restype = ctypes.c_int
    lib.njode_walk_train_scratch_floats.argtypes = [
        ctypes.POINTER(ctypes.c_int)]
    lib.njode_walk_train_scratch_floats.restype = ctypes.c_longlong
    return lib


def _tableau_array(ode_solver: str, dt: float):
    """[da (4 x 4), dc (4), bw (4), gb (4)], each dt product rounded from
    double once, as the JAX kernel's trace-time constants."""
    stages, bweights = _TABLEAU[ode_solver]
    tab = [0.0] * 28
    for i, (aij, ci) in enumerate(stages):
        for j, a in aij:
            tab[4 * i + j] = dt * a
        tab[16 + i] = dt * ci
        tab[20 + i] = bweights[i]
        tab[24 + i] = dt * bweights[i]
    return (ctypes.c_float * 28)(*tab)


def fused_walk_train_run(state: WalkState, data: torch.Tensor, *,
                         n_slots: int, num_moments: int, batch_size: int,
                         hidden_dim: int, dt_ode_step: float,
                         max_substeps: int, activation: str = "relu",
                         input_scaling: str = "identity", lr: float = 1e-3,
                         weight_decay: float = 0.0,
                         moment_weights=(1.0, 10.0), eps: float = 1e-10,
                         variance_method: str = "direct",
                         betas=(0.9, 0.999), adam_eps: float = 1e-8,
                         ode_solver: str = "euler",
                         mxu_dtype: str = "float32"):
    """Run ``data.shape[0] // batch_size`` Adam steps of the grid-walk
    model: the CUDA kernel for CUDA tensors, its plain version for CPU
    tensors, an error otherwise.  ``mxu_dtype="bfloat16"`` takes the
    kernel's bf16 instances (row 13b), counted in ``LAUNCHES_BF16``.

    state: from :func:`init_walk_state` or :func:`walk_state_from`, or a
           previous call (the Adam powers carry over, so calls resume).
    data:  (G * batch_size, 2 n_slots + 1) rows from ``pack_minibatches``,
           every observation time on the grid {g * dt_ode_step}, g <= M.
    Returns (new state, (G,) per-step losses); the input state is kept.
    """
    global LAUNCHES, LAUNCHES_BF16
    tensors = {"data": data, **state._asdict()}
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in tensors.values()):
        raise RuntimeError("fused_walk_train_run computes its own gradients;"
                           " call it on tensors that do not require grad")
    kw = dict(n_slots=n_slots, num_moments=num_moments,
              batch_size=batch_size, hidden_dim=hidden_dim,
              dt_ode_step=dt_ode_step, max_substeps=max_substeps,
              activation=activation, input_scaling=input_scaling, lr=lr,
              weight_decay=weight_decay, moment_weights=moment_weights,
              eps=eps, variance_method=variance_method, betas=betas,
              adam_eps=adam_eps, ode_solver=ode_solver, mxu_dtype=mxu_dtype)
    if all(x.device.type == "cpu" for x in tensors.values()):
        return fused_walk_train_run_reference(state, data, **kw)
    device = data.device
    if device.type != "cuda" or any(x.device != device
                                     for x in tensors.values()):
        raise ValueError(f"fused_walk_train_run: no kernel for device "
                         f"{device} (or tensors on mixed devices)")
    _check_args(num_moments, activation, input_scaling, batch_size, data,
                n_slots, variance_method, ode_solver, mxu_dtype)
    H, K, N, BS = hidden_dim, num_moments, n_slots, batch_size
    P = n_params(H, K)
    shapes = {"data": tuple(data.shape), "params": (P,), "m": (P,),
              "v": (P,), "stat": (2,)}
    for name, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"fused_walk_train_run: the CUDA kernel takes "
                            f"float32, {name} is {x.dtype}")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"fused_walk_train_run: {name} has shape "
                             f"{tuple(x.shape)}, expected {shapes[name]}")
        if not x.is_contiguous():
            raise ValueError(f"fused_walk_train_run: {name} must be "
                             "contiguous")
    plan = launch_plan(H, BS, N, ode_solver, max_substeps)
    if plan is None or int(max_substeps) < 1:
        raise ValueError(f"fused_walk_train_run: hidden_dim {H}, batch "
                         f"{BS} and {ode_solver} do not fit the kernel (1 <= "
                         f"H <= {MAX_HIDDEN}, batch <= {MAX_BATCH}, the "
                         "block's shared memory), or max_substeps < 1")
    dt = float(dt_ode_step)
    G = data.shape[0] // BS
    n_st = len(_TABLEAU[ode_solver][0])
    w0 = float(moment_weights[0])
    w1 = float(moment_weights[1]) if len(moment_weights) > 1 else 1.0
    b1, b2 = float(betas[0]), float(betas[1])
    inv_n = 1.0 / float(N)
    dims = (ctypes.c_int * 15)(
        K, H, N, BS, G, int(max_substeps), SUPPORTED_ACTS.index(activation),
        SCALINGS.index(input_scaling), int(variance_method == "second_moment"),
        plan.warps, int(plan.four), n_st, plan.chunk, plan.wpt,
        int(mxu_dtype == "bfloat16"))
    # constants rounded from double once, as the JAX kernel's python floats
    hyper = (ctypes.c_float * 16)(
        dt, 1.0 / dt, dt if ode_solver == "euler" else 0.0, lr, weight_decay,
        b1, b2, 1.0 - b1, 1.0 - b2, adam_eps, eps, w0, w1, inv_n, w0 * inv_n,
        w1 * inv_n)
    lib = _load_kernel()
    out = WalkState(*(x.clone() for x in state))
    losses = torch.empty(G, dtype=torch.float32, device=device)
    scratch = torch.empty(int(lib.njode_walk_train_scratch_floats(dims)),
                          dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.njode_walk_train_run(
            data.data_ptr(), out.params.data_ptr(), out.m.data_ptr(),
            out.v.data_ptr(), out.stat.data_ptr(), losses.data_ptr(),
            scratch.data_ptr(), dims, hyper, _tableau_array(ode_solver, dt),
            plan.smem_bytes, stream)
    from ._build import check
    check(lib, err, "njode_walk_train_run launch")
    if mxu_dtype == "bfloat16":
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return out, losses
