"""A whole training run of minibatch Adam steps in one CUDA kernel.

Port of ``njode_tpu/ops/train_kernel.py``.  The default recipe (hidden 32,
two separate moment networks, batch 128, 1,000 trajectories per epoch) is a
long chain of small sequential steps; the kernel runs all of an epoch's
steps in one launch: forward, the closed-form loss gradient, backward and
Adam, with the parameters and Adam state kept on chip.

Kernel: ``csrc/train_run.cu`` (``njode_train_run``), which replaces the TPU
kernels ``_train_kernel`` (``train_kernel.py:223``) and ``_train_kernel_dual``
(``:478``).  They compute one function; the dual pack is a TPU lane layout
and the port's kernel takes logical shapes instead.  See the source for the
design.

Scope, as the JAX package's (:func:`train_kernel_available`): separate
networks, d_x = d_y = 1, one hidden layer, no dropout, ``dt_ode_step=None``,
euler, an activation and scaling with f(0) = 0, K in {1, 2} moments,
``ignore_first_continuity``.  The port's own gates on the shapes
(:func:`kernel_fits`): H a multiple of 4 up to 128 (the products read
float4s), N >= 2, any batch size >= 1, and one warp's working set must fit
the H100's shared memory.

Layout of the train state (:class:`TrainState`), all float32:

* ``params``, ``m``, ``v``: (K, P) with P = 4 H^2 + 10 H + 1 per network:
  the (in, out) matrices J2 (jump hidden), O1 (readout hidden), W1h (the
  h rows of the ODEFunc's first layer), W2 (its second layer), each H x H
  row-major; then the vectors j1, bj1 (jump input layer), bj2, w1x, w1t,
  w1d (the ODEFunc's x, t_rel and t_elapsed rows), b1, b2, bo1, o2 (readout
  output weights), each H; then the scalar bo2.
* ``stat``: (2,) the Adam bias-correction powers [b1^t, b2^t].

Data: (G * batch_size, 2N + 1) rows [x_0..x_{N-1}, t_0..t_{N-1}, valid]
(:func:`pack_minibatches`); each consecutive ``batch_size`` rows are one
minibatch, and rows with valid 0 pad the last one.

Wrapper: :func:`fused_train_run` launches the kernel for CUDA tensors and
takes its plain version :func:`fused_train_run_reference` only for CPU
tensors.  The functions :func:`init_train_state`, :func:`train_state_params`,
:func:`kernel_state_from` and :func:`optax_state_into` map between the train
state and the model's ``state_dict`` and ``torch.optim.Adam``'s.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from .activations import (_ACT, _ACT_GRAD, _SCALE, _SCALE_GRAD, SCALINGS,
                          SUPPORTED_ACTS, packed_state_safe)

# launches of the CUDA kernel in this process; callers may reset it to 0
LAUNCHES = 0

N_VEC = 10
(J1, BJ1, BJ2, W1X, W1T, W1D, B1, B2, BO1, O2) = range(N_VEC)
MAX_HIDDEN = 128
MAX_WARPS = 12
# the H100's shared memory a block may opt into, less the kernel's static use
# (kReserve in the source, which refuses a plan the card cannot hold)
SMEM_BYTES = 232448 - 64


class TrainState(NamedTuple):
    params: torch.Tensor   # (K, P)
    m: torch.Tensor        # (K, P)
    v: torch.Tensor        # (K, P)
    stat: torch.Tensor     # (2,) [b1^t, b2^t]


def n_params_per_net(hidden_dim: int) -> int:
    return 4 * hidden_dim * hidden_dim + N_VEC * hidden_dim + 1


def hidden_from_size(P: int) -> int:
    """H with 4 H^2 + 10 H + 1 == P; raises if there is none."""
    H = int(round((-10 + math.sqrt(100 + 16 * (P - 1))) / 8))
    if H < 1 or n_params_per_net(H) != P:
        raise ValueError(f"train kernel: {P} floats per network is no "
                         "4H^2 + 10H + 1")
    return H


def train_kernel_available(shared_network, input_dim, output_dim,
                           n_hidden_layers, activation, dropout_rate,
                           input_scaling, dt_ode_step,
                           ode_solver="euler") -> bool:
    """Whether the kernel computes this model configuration (the JAX
    package's scope, ``njode_tpu/ops/train_kernel.py:92``)."""
    return (not shared_network and input_dim == 1 and output_dim == 1
            and n_hidden_layers == 1 and dropout_rate == 0.0
            and dt_ode_step is None and ode_solver == "euler"
            and packed_state_safe(activation, input_scaling))


def batch_size_ok(batch_size) -> bool:
    """The kernel takes any minibatch of at least one row."""
    return batch_size is not None and int(batch_size) >= 1


def _slot_floats(H: int, N: int, input_scaling: str) -> int:
    """One warp's working set for one trajectory (``slot_floats`` in the
    source): 4N + 3(2N-1) + 4 or 5 (N-1) + 3 rows of H, and 8N - 4 scalars."""
    S, R = N - 1, 2 * N - 1
    rows = 4 * N + 3 * R + (4 if input_scaling == "identity" else 5) * S + 3
    return (rows * H + 8 * N - 4 + 3) & ~3


def _staged_floats(H: int) -> int:
    """One network's weights with matrix rows padded to H + 4 floats."""
    return (4 * H * (H + 4) + N_VEC * H + 1 + 3) & ~3


def launch_plan(hidden_dim: int, n_slots: int, batch_size: int,
                input_scaling: str = "identity"
                ) -> Optional[tuple[int, bool, int]]:
    """The kernel's launch plan on an H100: (warps, weights staged in shared
    memory, shared-memory bytes), or None where the shapes do not fit.  As
    many warps as shared memory holds, up to ``MAX_WARPS`` and the batch
    size; the weights are staged when they fit beside two warps' slots."""
    H, N = hidden_dim, n_slots
    if not (4 <= H <= MAX_HIDDEN and H % 4 == 0 and N >= 2
            and batch_size >= 1):
        return None
    slot_b = 4 * _slot_floats(H, N, input_scaling)
    stage_b = 4 * _staged_floats(H)
    staged = stage_b + 2 * slot_b <= SMEM_BYTES
    c = (SMEM_BYTES - stage_b) // slot_b if staged else SMEM_BYTES // slot_b
    c = min(c, MAX_WARPS, batch_size)
    if c < 1:
        return None
    return c, staged, (stage_b if staged else 0) + c * slot_b


def kernel_fits(hidden_dim: int, n_slots: int,
                input_scaling: str = "identity") -> bool:
    return launch_plan(hidden_dim, n_slots, 1, input_scaling) is not None


# --------------------------------------------------------------------------
# layout: model / optimizer state <-> train state
# --------------------------------------------------------------------------

def _names(k: int) -> dict[str, str]:
    return {
        "j_in": f"jump_nns.{k}.net.0", "j_hid": f"jump_nns.{k}.net.3",
        "ode1": f"ode_funcs.{k}.net.0", "ode2": f"ode_funcs.{k}.net.3",
        "o_hid": f"output_nns.{k}.net.0", "o_out": f"output_nns.{k}.net.3",
    }


def _pack_net(sd: dict, k: int, H: int) -> torch.Tensor:
    """One network's tensors (state-dict names, torch orientation) -> (P,)."""
    n = _names(k)
    w = lambda key: sd[f"{n[key]}.weight"]
    b = lambda key: sd[f"{n[key]}.bias"]
    ode1 = w("ode1")
    parts = [w("j_hid").t(), w("o_hid").t(), ode1[:, :H].t(), w("ode2").t(),
             w("j_in")[:, 0], b("j_in"), b("j_hid"), ode1[:, H], ode1[:, H + 1],
             ode1[:, H + 2], b("ode1"), b("ode2"), b("o_hid"), w("o_out")[0],
             b("o_out")]
    return torch.cat([p.reshape(-1) for p in parts]).to(torch.float32)


def _unpack_net(flat: torch.Tensor, k: int, H: int) -> dict:
    """Inverse of :func:`_pack_net` for one (P,) block."""
    HH = H * H
    mat = lambda i: flat[i * HH:(i + 1) * HH].reshape(H, H).t()
    vec = lambda i: flat[4 * HH + i * H:4 * HH + (i + 1) * H]
    n = _names(k)
    ode1 = torch.cat([mat(2), vec(W1X)[:, None], vec(W1T)[:, None],
                      vec(W1D)[:, None]], dim=1)
    out = {
        "j_in": (vec(J1)[:, None], vec(BJ1)), "j_hid": (mat(0), vec(BJ2)),
        "ode1": (ode1, vec(B1)), "ode2": (mat(3), vec(B2)),
        "o_hid": (mat(1), vec(BO1)),
        "o_out": (vec(O2)[None, :], flat[4 * HH + N_VEC * H:]),
    }
    sd = {}
    for key, (weight, bias) in out.items():
        sd[f"{n[key]}.weight"] = weight.contiguous()
        sd[f"{n[key]}.bias"] = bias.contiguous()
    return sd


def _pack(sd: dict, K: int, H: int) -> torch.Tensor:
    return torch.stack([_pack_net(sd, k, H) for k in range(K)]).contiguous()


def _unpack(flat: torch.Tensor, H: int) -> dict:
    sd = {}
    for k in range(flat.shape[0]):
        sd.update(_unpack_net(flat[k], k, H))
    return sd


def _powers(step: float, betas, device) -> torch.Tensor:
    b = torch.tensor(betas, dtype=torch.float32, device=device)
    return b ** torch.tensor(float(step), dtype=torch.float32, device=device)


def init_train_state(model) -> TrainState:
    """The model's parameters as a train state with fresh Adam moments
    (zeros) and powers [1, 1]."""
    params = _pack(model.state_dict(), model.num_moments, model.hidden_dim)
    z = torch.zeros_like(params)
    return TrainState(params, z, z.clone(),
                      torch.ones(2, dtype=torch.float32, device=params.device))


def train_state_params(state: TrainState, hidden_dim: int) -> dict:
    """The model ``state_dict`` entries a train state holds."""
    return _unpack(state.params, hidden_dim)


def kernel_state_from(model, opt_state_dict: dict,
                      betas=(0.9, 0.999)) -> TrainState:
    """(model, ``torch.optim.Adam.state_dict()``) -> the train state.

    The optimizer's state is indexed by the order of ``model.parameters()``;
    exp_avg and exp_avg_sq pack through the same layout as the parameters,
    and the powers come from the step count, so a kernel run resumes exactly
    where the composed trainer stopped and back."""
    names = [n for n, _ in model.named_parameters()]
    sd = model.state_dict()
    params = _pack(sd, model.num_moments, model.hidden_dim)
    state = opt_state_dict.get("state", {})
    if not state:
        z = torch.zeros_like(params)
        return TrainState(params, z, z.clone(), _powers(0, betas, params.device))
    per = {names[i]: s for i, s in state.items()}
    steps = {float(s["step"]) for s in per.values()}
    if len(per) != len(names) or len(steps) != 1:
        raise ValueError("train kernel: the Adam state must cover every "
                         "parameter with one step count")
    dev = params.device
    m = _pack({n: s["exp_avg"].to(dev) for n, s in per.items()},
              model.num_moments, model.hidden_dim)
    v = _pack({n: s["exp_avg_sq"].to(dev) for n, s in per.items()},
              model.num_moments, model.hidden_dim)
    return TrainState(params, m, v, _powers(steps.pop(), betas, dev))


def optax_state_into(state: TrainState, n_steps: int, opt_state_dict: dict,
                     model) -> tuple[dict, dict]:
    """Train state after ``n_steps`` more steps -> (model ``state_dict``,
    ``torch.optim.Adam`` ``state_dict``), the optimizer's step counts
    advanced by ``n_steps`` and its param groups kept."""
    H = model.hidden_dim
    names = [n for n, _ in model.named_parameters()]
    params = _unpack(state.params, H)
    m, v = _unpack(state.m, H), _unpack(state.v, H)
    old = opt_state_dict.get("state", {})
    step = float(old[0]["step"]) if old else 0.0
    new_state = {
        i: {"step": torch.tensor(step + n_steps, dtype=torch.float32),
            "exp_avg": m[n], "exp_avg_sq": v[n]}
        for i, n in enumerate(names)}
    sd = dict(model.state_dict())
    sd.update(params)
    return sd, {"state": new_state,
                "param_groups": opt_state_dict["param_groups"]}


def pack_minibatches(times: torch.Tensor, values: torch.Tensor,
                     valid: torch.Tensor, batch_size: int) -> torch.Tensor:
    """(B, N) times, (B, N, 1) values and (B,) valid flags, B a multiple of
    ``batch_size`` -> the kernel's (B, 2N + 1) rows."""
    B, N = times.shape
    if B % batch_size:
        raise ValueError(f"train kernel: rows {B} not a multiple of the "
                         f"minibatch size {batch_size}")
    return torch.cat([values[..., 0].to(torch.float32),
                      times.to(torch.float32),
                      valid.to(torch.float32)[:, None]], dim=1).contiguous()


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def _views(p: torch.Tensor, H: int) -> dict:
    HH = H * H
    w = {name: p[i * HH:(i + 1) * HH].reshape(H, H)
         for i, name in enumerate(("J2", "O1", "W1h", "W2"))}
    for i, name in enumerate(("j1", "bj1", "bj2", "w1x", "w1t", "w1d", "b1",
                              "b2", "bo1", "o2")):
        w[name] = p[4 * HH + i * H:4 * HH + (i + 1) * H]
    w["bo2"] = p[4 * HH + N_VEC * H]
    return w


def _forward(w: dict, x: torch.Tensor, t: torch.Tensor, act: str,
             scale: str) -> tuple[torch.Tensor, dict]:
    """Slot-batched forward of one network over a minibatch: x, t (BS, N)
    -> predictions (BS, 2N-1) (rows < N after-jump at each slot, row N+g
    before-jump at slot g+1) and the residuals of the backward."""
    A, SC = _ACT[act], _SCALE[scale]
    N = x.shape[1]
    S = N - 1
    a1p = x[..., None] * w["j1"] + w["bj1"]                  # (BS, N, H)
    a1 = A(a1p)
    hjp = torch.matmul(a1, w["J2"]) + w["bj2"]
    hj = A(hjp)
    schj = SC(hj[:, :S])
    scx, t0 = SC(x[:, :S]), t[:, :S]
    dt = t[:, 1:] - t[:, :-1]
    base = (scx[..., None] * w["w1x"] + t0[..., None] * w["w1t"]
            + dt[..., None] * w["w1d"] + w["b1"])
    g1p = torch.matmul(schj, w["W1h"]) + base
    g1 = A(g1p)
    dh = torch.matmul(g1, w["W2"]) + w["b2"]
    hm = hj[:, :S] + dt[..., None] * dh
    inp = torch.cat([hj, hm], dim=1)                         # (BS, 2N-1, H)
    up = torch.matmul(inp, w["O1"]) + w["bo1"]
    u = A(up)
    y = (u * w["o2"]).sum(-1) + w["bo2"]
    res = dict(x=x, t0=t0, dt=dt, scx=scx, a1p=a1p, a1=a1, hjp=hjp, hj=hj,
               schj=schj, g1p=g1p, g1=g1, inp=inp, up=up, u=u)
    return y, res


def _loss_and_cotangents(x, valid, y0, y1, *, eps, w0, w1, variance_method,
                         K):
    """The closed-form loss of one minibatch and its cotangents with respect
    to each network's predictions (``njode_tpu/ops/train_kernel.py:119``).

    x (BS, N); valid (BS,); y0, y1 (BS, 2N-1) predictions of nets 0 and 1
    (y1 None for K = 1).  Returns (L, g0, g1) with g* (BS, 2N-1)."""
    N = x.shape[1]
    inv_n = 1.0 / float(N)
    cont = torch.arange(N, device=x.device) > 0       # slot 0 continuity off

    def split(y):   # after-jump (BS, N), before-jump (BS, N) with slot 0 = 0
        return y[:, :N], torch.cat([torch.zeros_like(y[:, :1]), y[:, N:]], 1)

    def join(gA, gB):
        return torch.cat([gA, gB[:, 1:]], dim=1)

    A0, B0 = split(y0)
    aj = (x - A0) ** 2
    ac = torch.where(cont, (x - B0) ** 2, 0.0)
    SA, SCt = torch.sqrt(aj + eps), torch.sqrt(ac + eps)
    L0 = ((SA + SCt) ** 2).sum(1) * inv_n
    nv = torch.clamp_min(valid.sum(), 1.0)
    wrow = (valid / nv)[:, None]
    gA0 = wrow * (w0 * inv_n) * ((SA + SCt) / SA) * 2.0 * (A0 - x)
    gB0 = torch.where(cont, wrow * (w0 * inv_n) * ((SA + SCt) / SCt) * 2.0
                      * (B0 - x), 0.0)
    if K == 1:
        return (w0 * L0 * valid).sum() / nv, join(gA0, gB0), None

    A1, B1 = split(y1)
    if variance_method == "direct":
        V, Vb, Z, Zb = A1 ** 2, B1 ** 2, aj, ac
        dV, dVb = 2.0 * A1, 2.0 * B1
    else:                                              # second_moment
        V, Vb = A1, B1
        Z = Zb = x ** 2
        dV = dVb = 1.0
    avj = (Z - V) ** 2
    avc = torch.where(cont, (Zb - Vb) ** 2, 0.0)
    SVA, SVC = torch.sqrt(avj + eps), torch.sqrt(avc + eps)
    L1 = ((SVA + SVC) ** 2).sum(1) * inv_n
    L = ((w0 * L0 + w1 * L1) * valid).sum() / nv
    gA1 = wrow * (w1 * inv_n) * ((SVA + SVC) / SVA) * 2.0 * (V - Z) * dV
    gB1 = torch.where(cont, wrow * (w1 * inv_n) * ((SVA + SVC) / SVC) * 2.0
                      * (Vb - Zb) * dVb, 0.0)
    return L, join(gA0, gB0), join(gA1, gB1)


def _backward(w: dict, res: dict, gy: torch.Tensor, act: str,
              scale: str) -> torch.Tensor:
    """The hand-written backward of :func:`_forward`: the (P,) gradient of
    sum(gy * y) with respect to one network's flat parameters."""
    AG, SG = _ACT_GRAD[act], _SCALE_GRAD[scale]
    N = res["x"].shape[1]
    S = N - 1

    def outer(a, g):                                   # sum over rows of a^T g
        return torch.einsum("bri,brj->ij", a, g)

    def colsum(z):
        return z.sum(dim=(0, 1))

    dup = (gy[..., None] * w["o2"]) * AG(res["up"])
    do2 = colsum(res["u"] * gy[..., None])
    dO1 = outer(res["inp"], dup)
    dbo1 = colsum(dup)
    dbo2 = gy.sum()
    din = torch.matmul(dup, w["O1"].t())
    dhm = din[:, N:]
    ddh = res["dt"][..., None] * dhm
    dW2 = outer(res["g1"], ddh)
    db2 = colsum(ddh)
    dg1p = torch.matmul(ddh, w["W2"].t()) * AG(res["g1p"])
    dW1h = outer(res["schj"], dg1p)
    dw1x = colsum(res["scx"][..., None] * dg1p)
    dw1t = colsum(res["t0"][..., None] * dg1p)
    dw1d = colsum(res["dt"][..., None] * dg1p)
    db1 = colsum(dg1p)
    dhjg = dhm + torch.matmul(dg1p, w["W1h"].t()) * SG(res["hj"][:, :S])
    dhj = din[:, :N] + torch.cat([dhjg, torch.zeros_like(dhjg[:, :1])], 1)
    dhjp = dhj * AG(res["hjp"])
    dJ2 = outer(res["a1"], dhjp)
    dbj2 = colsum(dhjp)
    da1p = torch.matmul(dhjp, w["J2"].t()) * AG(res["a1p"])
    dj1 = colsum(res["x"][..., None] * da1p)
    dbj1 = colsum(da1p)
    return torch.cat([dJ2.reshape(-1), dO1.reshape(-1), dW1h.reshape(-1),
                      dW2.reshape(-1), dj1, dbj1, dbj2, dw1x, dw1t, dw1d, db1,
                      db2, dbo1, do2, dbo2.reshape(1)])


def _adam_math(p, m, v, g, *, c1, c2, lr, wd, b1, b2, eps_adam):
    """Torch-style Adam (L2 into the gradient, biased moments, bias-corrected
    step; ``njode_tpu/ops/train_kernel.py:199``).  Returns (p', m', v')."""
    g = g + wd * p
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    m_hat = m / (1.0 - c1)
    v_hat = v / (1.0 - c2)
    return p - lr * m_hat / (torch.sqrt(v_hat) + eps_adam), m, v


def _check_args(num_moments, activation, input_scaling, batch_size, data,
                n_slots, variance_method):
    if num_moments not in (1, 2):
        raise ValueError("train kernel: K in (1, 2) moments only (the "
                         "closed-form loss covers mean and mean+variance)")
    if activation not in SUPPORTED_ACTS or input_scaling not in SCALINGS \
            or not packed_state_safe(activation, input_scaling):
        raise ValueError(f"train kernel: {activation}/{input_scaling} is "
                         "not an f(0)=0 activation and scaling")
    if variance_method not in ("direct", "second_moment"):
        raise ValueError(f"Unknown variance_method: {variance_method}")
    if not batch_size_ok(batch_size):
        raise ValueError(f"train kernel: batch_size {batch_size} must be "
                         "a positive integer")
    if data.ndim != 2 or data.shape[1] != 2 * n_slots + 1:
        raise ValueError(f"train kernel: data has shape {tuple(data.shape)},"
                         f" expected (rows, {2 * n_slots + 1})")
    if data.shape[0] % batch_size:
        raise ValueError("train kernel: data rows must be a whole number "
                         "of minibatches")


def fused_train_run_reference(state: TrainState, data: torch.Tensor, *,
                              n_slots: int, num_moments: int,
                              batch_size: int, activation: str = "relu",
                              input_scaling: str = "identity",
                              lr: float = 1e-3, weight_decay: float = 0.0,
                              moment_weights=(1.0, 10.0), eps: float = 1e-10,
                              variance_method: str = "direct",
                              betas=(0.9, 0.999), adam_eps: float = 1e-8):
    """Plain PyTorch version of the kernel, on any device: the same algebra
    as plain tensor ops, a Python loop over the steps.  Same arguments and
    result as :func:`fused_train_run`.  Net 0's forward runs once per step:
    the kernel's second forward of net 0 recomputes the same values."""
    _check_args(num_moments, activation, input_scaling, batch_size, data,
                n_slots, variance_method)
    K, N, BS = num_moments, n_slots, batch_size
    H = hidden_from_size(state.params.shape[1])
    w0 = float(moment_weights[0])
    w1 = float(moment_weights[1]) if len(moment_weights) > 1 else 1.0
    b1, b2 = float(betas[0]), float(betas[1])
    params = state.params.clone()
    m, v = state.m.clone(), state.v.clone()
    c1, c2 = state.stat[0].clone(), state.stat[1].clone()
    losses = []
    adam = dict(lr=lr, wd=weight_decay, b1=b1, b2=b2, eps_adam=adam_eps)
    for g in range(data.shape[0] // BS):
        rows = data[g * BS:(g + 1) * BS]
        x, t, valid = rows[:, :N], rows[:, N:2 * N], rows[:, 2 * N]
        c1, c2 = c1 * b1, c2 * b2
        ws = [_views(params[k], H) for k in range(K)]
        fw = [_forward(ws[k], x, t, activation, input_scaling)
              for k in range(K)]
        L, g0, g1 = _loss_and_cotangents(
            x, valid, fw[0][0], fw[1][0] if K == 2 else None, eps=eps, w0=w0,
            w1=w1, variance_method=variance_method, K=K)
        losses.append(L)
        # net 1 first, as the kernel (and the TPU kernel) order the updates
        for k, gy in reversed(list(enumerate([g0, g1][:K]))):
            grad = _backward(ws[k], fw[k][1], gy, activation, input_scaling)
            params[k], m[k], v[k] = _adam_math(params[k], m[k], v[k], grad,
                                               c1=c1, c2=c2, **adam)
    loss = (torch.stack(losses) if losses
            else torch.zeros(0, device=data.device))
    return TrainState(params, m, v, torch.stack([c1, c2])), loss


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

@functools.cache
def _load_kernel():
    """Build (first call only) and bind ``njode_train_run``."""
    from ._build import load
    lib = load("train_run")
    fn = lib.njode_train_run
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_float),
                                            ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def fused_train_run(state: TrainState, data: torch.Tensor, *, n_slots: int,
                    num_moments: int, batch_size: int,
                    activation: str = "relu",
                    input_scaling: str = "identity", lr: float = 1e-3,
                    weight_decay: float = 0.0, moment_weights=(1.0, 10.0),
                    eps: float = 1e-10, variance_method: str = "direct",
                    betas=(0.9, 0.999), adam_eps: float = 1e-8):
    """Run ``data.shape[0] // batch_size`` Adam steps: the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors, an error otherwise.

    state: from :func:`init_train_state` or :func:`kernel_state_from`, or a
           previous call (the Adam powers carry over, so calls resume).
    data:  (G * batch_size, 2 n_slots + 1) rows from :func:`pack_minibatches`.
    Returns (new state, (G,) per-step losses).  The input state is not
    modified.
    """
    global LAUNCHES
    tensors = {"data": data, **state._asdict()}
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in tensors.values()):
        raise RuntimeError("fused_train_run computes its own gradients; "
                           "call it on tensors that do not require grad")
    kw = dict(n_slots=n_slots, num_moments=num_moments,
              batch_size=batch_size, activation=activation,
              input_scaling=input_scaling, lr=lr,
              weight_decay=weight_decay, moment_weights=moment_weights,
              eps=eps, variance_method=variance_method, betas=betas,
              adam_eps=adam_eps)
    if all(x.device.type == "cpu" for x in tensors.values()):
        return fused_train_run_reference(state, data, **kw)
    device = data.device
    if device.type != "cuda" or any(x.device != device
                                     for x in tensors.values()):
        raise ValueError(f"fused_train_run: no kernel for device {device} "
                         "(or tensors on mixed devices)")
    _check_args(num_moments, activation, input_scaling, batch_size, data,
                n_slots, variance_method)
    K, P = state.params.shape[0], state.params.shape[-1]
    H = hidden_from_size(P)
    shapes = {"data": tuple(data.shape), "params": (num_moments, P),
              "m": (num_moments, P), "v": (num_moments, P), "stat": (2,)}
    for name, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"fused_train_run: the CUDA kernel takes "
                            f"float32, {name} is {x.dtype}")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"fused_train_run: {name} has shape "
                             f"{tuple(x.shape)}, expected {shapes[name]}")
        if not x.is_contiguous():
            raise ValueError(f"fused_train_run: {name} must be contiguous")
    plan = launch_plan(H, n_slots, batch_size, input_scaling)
    if plan is None:
        raise ValueError(f"fused_train_run: hidden_dim {H} and {n_slots} "
                         "slots do not fit the kernel (H a multiple of 4 up "
                         f"to {MAX_HIDDEN}, N >= 2, one warp's working set "
                         "in shared memory)")
    G = data.shape[0] // batch_size
    w0 = float(moment_weights[0])
    w1 = float(moment_weights[1]) if len(moment_weights) > 1 else 1.0
    b1, b2 = float(betas[0]), float(betas[1])
    inv_n = 1.0 / float(n_slots)
    warps, staged, _ = plan
    dims = (ctypes.c_int * 10)(K, H, n_slots, batch_size, G,
                               SUPPORTED_ACTS.index(activation),
                               SCALINGS.index(input_scaling),
                               int(variance_method == "second_moment"),
                               warps, int(staged))
    # constants rounded from double once, as the JAX kernel's python floats
    hyper = (ctypes.c_float * 13)(lr, weight_decay, b1, b2, 1.0 - b1,
                                  1.0 - b2, adam_eps, eps, w0, w1, inv_n,
                                  w0 * inv_n, w1 * inv_n)
    lib, fn = _load_kernel()
    out = TrainState(*(x.clone() for x in state))
    losses = torch.empty(G, dtype=torch.float32, device=device)
    scratch = torch.empty(_staged_floats(H) + P
                          + batch_size * (2 * n_slots - 1) + batch_size,
                          dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(data.data_ptr(), out.params.data_ptr(), out.m.data_ptr(),
                 out.v.data_ptr(), out.stat.data_ptr(), losses.data_ptr(),
                 scratch.data_ptr(), dims, hyper, stream)
    from ._build import check
    check(lib, err, "njode_train_run launch")
    LAUNCHES += 1
    return out, losses
