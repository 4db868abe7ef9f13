"""The fused whole-step kernels' port (njode_tpu_torch/ops/fused_step.py)
held against the JAX package's ``njode_tpu/ops/fused_step.py`` on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_fused_step.py`` does; the port's wrappers take the kernels'
plain versions for CPU tensors.  Weights come from the JAX init through
``state_dict_from_jax``; inputs from numpy with a fixed seed.  Tolerances:

* forward rtol 2e-5 / atol 2e-6 (the JAX package's own for its kernel);
* loss rtol 1e-5, parameter gradients rtol 5e-4 / atol 1e-5 (the JAX
  package's for its lane-space loss: f32 sums over rows and slots in
  another order);
* the Trainer: per-step losses rtol 2e-5, parameters and Adam moments
  rtol 1e-4 / atol 2e-6 (``tests/test_torch_training.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.overrides import TorchFunctionMode

import chip_smoke as cs
from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.ops import fused_step as jfs
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.ops import fused_step as fs
from njode_tpu_torch.utils import (Trainer, adam_state_from_jax, make_adam,
                                   run_experiment, state_dict_from_jax)

H, B = 24, 6
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def bridged(seed=0, d=1, L=1, K=2, shared=False, **kw):
    """The JAX model and params, and the port's model with the same
    weights (use_pallas 'step')."""
    cfg = dict(input_dim=d, hidden_dim=H, output_dim=d, num_moments=K,
               n_hidden_layers=L, shared_network=shared, **kw)
    jax_model = JaxModel(use_pallas="step-interpret", **cfg)
    params = jax_model.init(jax.random.PRNGKey(seed))
    port = NeuralJumpODE(**cfg, use_pallas="step", device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=K, shared_network=shared, n_hidden_layers=L))
    return jax_model, params, port


def batch(N, d=1, seed=1, padded=False):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 1.0, (B, N)), axis=1).astype(np.float32)
    times[:, 0] = 0.0
    values = (rng.normal(size=(B, N, d)) + 1.0).astype(np.float32)
    mask = np.ones((B, N), bool)
    if padded and N > 2:
        mask[-1, -2:] = False
        times[-1, -2:] = times[-1, -3]
        values[-1, -2:] = values[-1, -3]
    return times, values, mask


def step_kw(port):
    return port._step_kwargs()


def jax_kw(d=1, L=1, K=2, shared=False, act="relu", scale="identity"):
    return dict(num_moments=K, hidden_dim=H, activation=act,
                input_scaling=scale, interpret=True, shared_network=shared,
                input_dim=d, output_dim=d, n_hidden_layers=L)


# ------------------------------------------------------------- forward

FWD_CFGS = {
    "N1": dict(N=1), "N2": dict(N=2), "N5": dict(N=5), "N11": dict(N=11),
    "shared-N2": dict(N=2, shared=True), "shared-N5": dict(N=5, shared=True),
    "tanh-tanh": dict(N=4, act="tanh", scale="tanh"),
    "elu-sigmoid": dict(N=4, act="elu", scale="sigmoid"),
    "shared-elu-sigmoid": dict(N=3, shared=True, act="elu", scale="sigmoid"),
    "wide": dict(N=4, d=2, L=2),
    "shared-wide": dict(N=3, d=2, L=2, shared=True),
}


@pytest.mark.parametrize("name", list(FWD_CFGS))
def test_plain_forward_matches_jax(name):
    c = dict(FWD_CFGS[name])
    N, d, L = c.pop("N"), c.get("d", 1), c.get("L", 1)
    shared = c.get("shared", False)
    act, scale = c.get("act", "relu"), c.get("scale", "identity")
    _, params, port = bridged(seed=N, d=d, L=L, shared=shared,
                              activation=act, input_scaling=scale)
    times, values, _ = batch(N, d)
    ref = jfs.fused_step_apply(params, jnp.asarray(times),
                               jnp.asarray(values),
                               **jax_kw(d, L, 2, shared, act, scale))
    with torch.no_grad():
        ours = fs.fused_step_apply_packed(*fs.pack_params(port),
                                          torch.tensor(times),
                                          torch.tensor(values),
                                          **step_kw(port))
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)
    assert torch.all(ours[1][:, 0] == 0)


# ---------------------------------------------------------- loss, grads

LOSS_CFGS = {
    "direct-ifc": dict(N=5, ifc=True),
    "direct-N1": dict(N=1, ifc=False),
    "second-moment": dict(N=4, varm="second_moment", ifc=True),
    "wide-second-moment": dict(N=3, d=2, L=2, varm="second_moment",
                               ifc=True),
    "K3-extended": dict(N=4, K=3, ext=True, ifc=True),
    "shared": dict(N=5, shared=True, ifc=True),
    "shared-K3-extended": dict(N=3, d=2, K=3, shared=True, ext=True,
                               varm="second_moment", ifc=False),
}


def jax_grads_as_port(grads, K, shared, L):
    return state_dict_from_jax(grads, num_moments=K, shared_network=shared,
                               n_hidden_layers=L)


@pytest.mark.parametrize("name", list(LOSS_CFGS))
def test_loss_and_gradients_match_jax(name):
    """fused_step_loss (value and every parameter gradient, through
    pack_params and the explicit backward) against jax.value_and_grad of
    the JAX lane-space fused_step_loss: padded slots, a traj_mask, the
    first continuity term, weights [1, 10], both variance methods and
    extended moments."""
    c = LOSS_CFGS[name]
    N, d, L, K = c["N"], c.get("d", 1), c.get("L", 1), c.get("K", 2)
    shared = c.get("shared", False)
    _, params, port = bridged(seed=3, d=d, L=L, K=K, shared=shared)
    times, values, mask = batch(N, d, seed=11, padded=True)
    traj = np.ones(B, bool)
    traj[-2] = False
    mw = [1.0] + [10.0] * (K - 1)
    kw = dict(ignore_first_continuity=c["ifc"], moment_weights=mw,
              variance_method=c.get("varm", "direct"),
              extended_moments=c.get("ext", False))

    def jax_loss(p):
        return jfs.fused_step_loss(
            p, jnp.asarray(times), jnp.asarray(values), jnp.asarray(mask),
            traj_mask=jnp.asarray(traj), **jax_kw(d, L, K, shared), **kw)
    v_ref, g_ref = jax.value_and_grad(jax_loss)(params)
    loss = fs.fused_step_loss_packed(
        *fs.pack_params(port), torch.tensor(times), torch.tensor(values),
        torch.tensor(mask), traj_mask=torch.tensor(traj), **kw,
        **step_kw(port))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_ref), rtol=1e-5)
    named = dict(port.named_parameters())
    for key, ref in jax_grads_as_port(g_ref, K, shared, L).items():
        np.testing.assert_allclose(named[key].grad.numpy(), ref.numpy(),
                                   err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("name", ["direct-ifc", "direct-N1",
                                  "wide-second-moment", "shared"])
def test_records_and_dw_passes_match_jax_bwd_kernel(name):
    """The f32 backward's two passes in their plain versions,
    fused_step_records_reference (every plane's input rows A and
    pre-activation cotangents G over all rows, and dV) then
    step_dw_reference (dW = A^T G), held against the parameter cotangents
    of the JAX _bwd_kernel (interpret mode) through jax.value_and_grad of
    its fused_step_loss, at the gradient tolerance; the readout bias bo2
    stays outside the kernels and is not compared."""
    from njode_tpu_torch.models.loss import nj_ode_loss_dense
    c = LOSS_CFGS[name]
    N, d, L, K = c["N"], c.get("d", 1), c.get("L", 1), c.get("K", 2)
    shared = c.get("shared", False)
    _, params, port = bridged(seed=5, d=d, L=L, K=K, shared=shared)
    times, values, mask = batch(N, d, seed=13, padded=True)
    mw = [1.0] + [10.0] * (K - 1)
    kw = dict(ignore_first_continuity=c["ifc"], moment_weights=mw,
              variance_method=c.get("varm", "direct"),
              extended_moments=c.get("ext", False))

    def jax_loss(p):
        return jfs.fused_step_loss(
            p, jnp.asarray(times), jnp.asarray(values), jnp.asarray(mask),
            **jax_kw(d, L, K, shared), **kw)
    _, g_ref = jax.value_and_grad(jax_loss)(params)
    W, V, bo2 = (x.detach() for x in fs.pack_params(port))
    lo = fs.layout_of(port)
    T, X = torch.tensor(times), torch.tensor(values)
    Y = fs.fused_step_forward_reference(W, V, T, X, lo, "relu",
                                        "identity").requires_grad_()
    preds = Y[:, :N] + bo2.t()
    before = torch.cat([torch.zeros_like(preds[:, :1]), Y[:, N:] + bo2.t()],
                       1)
    loss = nj_ode_loss_dense(X, preds, before, torch.tensor(mask), **kw)
    gy, = torch.autograd.grad(loss, Y)
    records, dV = fs.fused_step_records_reference(W, V, T, X, gy, lo, "relu",
                                                  "identity")
    for planes in records:
        for m, rec in enumerate(planes):
            slots = N if m < L else (2 * N - 1 if m < 2 * L else N - 1)
            assert (rec is None) == (slots == 0)
            if rec is not None:
                assert rec[0].shape == rec[1].shape == (slots * B, H)
    dW = fs.step_dw_reference(records, H)
    got = fs.unpack_params(dW, dV, torch.zeros_like(bo2), num_moments=K,
                           hidden_dim=H, shared_network=shared, input_dim=d,
                           output_dim=d, n_hidden_layers=L)
    for key, ref in jax_grads_as_port(g_ref, K, shared, L).items():
        if key.startswith("output_nn") and key.endswith(f"net.{3 * L}.bias"):
            continue
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(),
                                   err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("shared,L,N,act,scale", [
    (False, 1, 2, "relu", "identity"), (True, 2, 5, "tanh", "tanh"),
    (False, 2, 3, "selu", "sigmoid"), (True, 1, 1, "elu", "identity")])
def test_plain_backward_matches_autograd(shared, L, N, act, scale):
    """fused_step_backward_reference (the explicit backward of row 10)
    against autograd through the plain forward, on random cotangents."""
    _, _, port = bridged(seed=4, L=L, shared=shared, activation=act,
                         input_scaling=scale)
    times, values, _ = batch(N, seed=5)
    t, x = torch.tensor(times), torch.tensor(values)
    W, V, _ = fs.pack_params(port)
    W, V = W.detach().requires_grad_(), V.detach().requires_grad_()
    lo = fs.layout_of(port)
    Y = fs.fused_step_forward_reference(W, V, t, x, lo, port._act_key,
                                        port._scale_key)
    gy = torch.tensor(np.random.default_rng(6).normal(
        size=tuple(Y.shape)).astype(np.float32))
    ref = torch.autograd.grad(Y, [W, V], gy)
    ours = fs.fused_step_backward_reference(W.detach(), V.detach(), t, x, gy,
                                            lo, port._act_key,
                                            port._scale_key)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------------- packing

@pytest.mark.parametrize("shared,d,L,K", [(False, 1, 1, 2), (True, 1, 1, 2),
                                          (False, 2, 2, 3), (True, 2, 2, 3)])
def test_pack_params_matches_jax_and_round_trips(shared, d, L, K):
    """The port's (W, V, bo2) of bridged weights equal the JAX pack_params
    cut to the logical [:H, :H] and rows (W in the same (in, out)
    orientation); unpack_params gives the state dict back exactly."""
    _, params, port = bridged(seed=7, d=d, L=L, K=K, shared=shared)
    W, V, bo2 = fs.pack_params(port)
    jW, jV, jbo2 = jfs.pack_params(params, num_moments=K, hidden_dim=H,
                                   shared_network=shared, input_dim=d,
                                   output_dim=d, n_hidden_layers=L)
    lo = fs.layout_of(port)
    assert lo.key() == jfs.StepLayout(L, d, d, K, shared).key()
    np.testing.assert_array_equal(W.detach().numpy(),
                                  np.asarray(jW)[:, :, :H, :H])
    np.testing.assert_array_equal(V.detach().numpy(),
                                  np.asarray(jV)[:, :lo.n_rows, :H])
    np.testing.assert_array_equal(bo2.detach().numpy(),
                                  np.asarray(jbo2).reshape(K, d))
    back = fs.unpack_params(W, V, bo2, num_moments=K, hidden_dim=H,
                            shared_network=shared, input_dim=d, output_dim=d,
                            n_hidden_layers=L)
    sd = port.state_dict()
    assert set(back) == set(sd)
    for key, val in sd.items():
        assert torch.equal(back[key], val), key


# --------------------------------------------------------------- model

@pytest.mark.parametrize("shared", [False, True])
def test_model_step_matches_jax_step_interpret(shared):
    """NeuralJumpODE(use_pallas='step') apply and apply_loss against the
    JAX model with 'step-interpret' (its fused-step branch)."""
    jax_model, params, port = bridged(seed=9, shared=shared)
    times, values, mask = batch(5, seed=13, padded=True)
    tj, vj, mj = (jnp.asarray(a) for a in (times, values, mask))
    assert jax_model._use_fused_step(5) and port._use_fused_step(5)
    ref = jax_model.apply(params, tj, vj, mj)
    with torch.no_grad():
        ours = port.apply(times, values, mask)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)
    kw = dict(ignore_first_continuity=True, moment_weights=[1.0, 10.0])
    v_ref, g_ref = jax.value_and_grad(
        lambda p: jax_model.apply_loss(p, tj, vj, mj, **kw))(params)
    loss = port.apply_loss(times, values, mask, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_ref), rtol=1e-5)
    named = dict(port.named_parameters())
    for key, ref in jax_grads_as_port(g_ref, 2, shared, 1).items():
        np.testing.assert_allclose(named[key].grad.numpy(), ref.numpy(),
                                   err_msg=key, **GRAD_TOL)


def _spy_route(monkeypatch):
    calls = []
    orig = fs.FusedStep.apply

    def spy(*a):
        calls.append(1)
        return orig(*a)
    monkeypatch.setattr(fs.FusedStep, "apply", spy)
    return calls


@pytest.mark.parametrize("case", ["step", "dropout", "dt_ode_step",
                                  "too-wide", "auto", "off", "step-bf16",
                                  "step-fp16"])
def test_routing(case, monkeypatch):
    """"step" takes the fused step where the model is eligible and the
    shapes fit, in float32 and bfloat16; dropout in use, a dt_ode_step, a
    hidden size past fused_step_fits, float16 (JAX ``jump_ode.py:260``),
    "auto" and False take the composed route (decided before any
    launch)."""
    kw = dict(input_dim=1, output_dim=1, num_moments=2, device="cpu")
    hidden, up, extra = 8, "step", {}
    if case.startswith("step-"):
        extra = dict(compute_dtype=case[5:])
    if case == "dropout":
        extra = dict(dropout_rate=0.1)
    elif case == "dt_ode_step":
        extra = dict(dt_ode_step=0.1)
    elif case == "too-wide":
        hidden = fs.MAX_HIDDEN + 1
    elif case in ("auto", "off"):
        up = {"auto": "auto", "off": False}[case]
    model = NeuralJumpODE(hidden_dim=hidden, use_pallas=up, **kw, **extra)
    times, values, _ = batch(3)
    calls = _spy_route(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    model.apply_loss(times, values, generator=gen, training=True).backward()
    takes = case in ("step", "step-bf16")
    assert bool(calls) == takes
    assert model._use_fused_step(3) == takes


@pytest.mark.parametrize("hidden,shared,N,L,batch_rows,on_card,takes", [
    (256, False, 2, 1, 4096, True, True), (256, False, 2, 1, 5000, True, True),
    (256, False, 2, 1, 4095, True, False),
    (255, False, 2, 1, 4096, True, False),
    (256, True, 2, 1, 4096, True, False),
    (256, False, 2, 1, 4096, False, False),
    (256, False, 11, 1, 512, True, False),
    (256, False, 11, 1, 4096, True, False),
    (256, False, 2, 2, 4096, True, False)])
def test_auto_takes_the_kernels_at_the_measured_shape(hidden, shared, N, L,
                                                      batch_rows, on_card,
                                                      takes, monkeypatch):
    """use_pallas='auto' takes the fused step only at the shape the H100 A/B
    had it ahead: on the card, separate networks, hidden 256, N 2, L 1,
    d_x = d_y = 1, K 2 and >= 4,096 batch rows; more slots or layers stay
    composed whatever the row count (the predicate alone; the device is
    stood in for)."""
    model = NeuralJumpODE(1, hidden, 1, num_moments=2, shared_network=shared,
                          n_hidden_layers=L, use_pallas="auto", device="cpu")
    if on_card:
        monkeypatch.setattr(NeuralJumpODE, "device",
                            property(lambda self: torch.device("cuda")))
    assert model._use_fused_step(N, batch_rows) == takes


@pytest.mark.parametrize("cdt", ["bfloat16", "float16"])
def test_auto_takes_a_compute_dtype_only_where_measured(cdt, monkeypatch):
    """'auto' at the measured shape on the card takes the kernels in a
    compute dtype only if AUTO_COMPUTE_DTYPES_H100 lists it: bfloat16,
    whose H100 A/B had rows 9b-10b ahead of the composed bf16 path
    (PERF.md); float16 never, even listed: the kernels have no float16
    mode."""
    model = NeuralJumpODE(1, 256, 1, num_moments=2, use_pallas="auto",
                          compute_dtype=cdt, device="cpu")
    monkeypatch.setattr(NeuralJumpODE, "device",
                        property(lambda self: torch.device("cuda")))
    assert fs.AUTO_COMPUTE_DTYPES_H100 == (None, torch.bfloat16)
    assert model._use_fused_step(2, 4096) == (cdt == "bfloat16")
    assert not model._use_fused_step(2, 4095)
    monkeypatch.setattr(fs, "AUTO_COMPUTE_DTYPES_H100",
                        (None, torch.bfloat16, torch.float16))
    assert model._use_fused_step(2, 4096) == (cdt == "bfloat16")


def test_fits_covers_the_recipes_and_refuses_the_rest():
    for H, N, L in ((256, 2, 1), (32, 10, 1), (50, 10, 1), (50, 11, 2),
                    (256, 10, 2)):
        assert fs.fused_step_fits(H, N, L, 1, 1, 2), (H, N, L)
    assert fs.launch_plan(256, 2, 1, 1, 1, 2) == (8, 4)
    assert not fs.fused_step_fits(fs.MAX_HIDDEN + 1, 2)
    assert not fs.fused_step_fits(256, 2000)
    assert not fs.fused_step_fits(0, 2)


@pytest.mark.parametrize("kw,match", [
    (dict(use_pallas="step-interpret"), "interpret mode"),
    (dict(use_pallas="step", compute_dtype="float8"), "Unknown compute_dtype"),
])
def test_unported_step_modes_raise(kw, match):
    """Pallas interpret mode has no port; an unknown compute dtype is a
    ValueError, as in the JAX package (bf16 runs: tests/test_torch_bf16.py)."""
    exc = ValueError if "compute_dtype" in kw else NotImplementedError
    with pytest.raises(exc, match=match):
        NeuralJumpODE(1, 8, 1, device="cpu", **kw)


def test_cpu_tensors_launch_no_kernel():
    """Neither the f32 nor the bf16 instances launch for CPU tensors."""
    _, _, port = bridged(seed=2)
    bf16 = NeuralJumpODE(1, H, 1, num_moments=2, use_pallas="step",
                         compute_dtype="bfloat16", device="cpu")
    bf16.load_state_dict(port.state_dict())
    fs.LAUNCHES_FWD = fs.LAUNCHES_BWD = 0
    fs.LAUNCHES_FWD_BF16 = fs.LAUNCHES_BWD_BF16 = 0
    times, values, _ = batch(3)
    for model in (port, bf16):
        model.apply_loss(times, values).backward()
    assert (fs.LAUNCHES_FWD, fs.LAUNCHES_BWD, fs.LAUNCHES_FWD_BF16,
            fs.LAUNCHES_BWD_BF16) == (0, 0, 0, 0)


# ------------------------------------------------------------- trainer

BS, NT, LR, WD = 8, 20, 1e-3, 5e-4


def trainer_data(seed=0, N=4):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 1.0, (NT, N)), axis=1).astype(np.float32)
    times[:, 0] = 0.0
    values = np.exp(rng.normal(size=(NT, N, 1)) * 0.3).astype(np.float32)
    return times, values


def test_trainer_steps_match_jax():
    """Three Adam steps through apply_loss on the fused step (the
    Trainer's composed step: the last minibatch padded and
    trajectory-masked) against the JAX model's 'step-interpret' loss and
    make_adam on identical data: per-step losses, parameters and the Adam
    moments (bridged by adam_state_from_jax)."""
    jax_model, params, port = bridged(seed=5)
    times, values = trainer_data()
    idx = np.concatenate([np.arange(NT), np.zeros(3 * BS - NT, int)])
    valid = np.arange(3 * BS) < NT
    kw = dict(ignore_first_continuity=True, moment_weights=[1.0, 10.0])
    tx = jax_make_adam(LR, WD)
    opt_state = tx.init(params)
    opt = make_adam(port.parameters(), LR, WD)
    step = jax.jit(jax.value_and_grad(
        lambda p, t, v, vm: jax_model.apply_loss(p, t, v, traj_mask=vm,
                                                 **kw)))
    for g in range(3):
        ids, vm = idx[g * BS:(g + 1) * BS], valid[g * BS:(g + 1) * BS]
        t, v = times[ids], values[ids]
        l_ref, grads = step(params, jnp.asarray(t), jnp.asarray(v),
                            jnp.asarray(vm))
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        loss = port.apply_loss(t, v, traj_mask=vm, **kw)
        loss.backward()
        opt.step()
        np.testing.assert_allclose(loss.item(), float(l_ref), rtol=2e-5)
    ref = state_dict_from_jax(params, num_moments=2, shared_network=False,
                              n_hidden_layers=1)
    for key, val in port.state_dict().items():
        np.testing.assert_allclose(val.numpy(), ref[key].numpy(), rtol=1e-4,
                                   atol=2e-6, err_msg=key)
    bridged_opt = adam_state_from_jax(opt_state, port, lr=LR,
                                      weight_decay=WD)
    for i, s in opt.state_dict()["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(
                s[k].numpy(), bridged_opt["state"][i][k].numpy(), rtol=1e-4,
                atol=2e-6)


def test_trainer_epoch_on_the_fused_step(capsys):
    """Trainer.train of a 'step' model on the CPU: the composed path with
    the fused step's plain versions, validation under no_grad on row 9's
    plain version alone; losses agree with the composed path of an
    identical model without the fused step."""
    _, params, port = bridged(seed=6)
    off = NeuralJumpODE(1, H, 1, num_moments=2, use_pallas=False,
                        device="cpu")
    off.load_state_dict(port.state_dict())
    times, values = trainer_data(1)
    vt, vv = trainer_data(2)
    hists = []
    for model in (port, off):
        tr = Trainer(model, make_adam(model.parameters(), LR, WD),
                     ignore_first_continuity=True,
                     moment_weights=[1.0, 10.0], seed=3)
        hists.append(tr.train(lambda: (times, values), lambda: (vt, vv),
                              n_epochs=2, batch_size=BS, print_every=1))
    paths = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("Training path:")]
    assert ["fused-step kernels" in line for line in paths] == [True, False]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hists[0][key], hists[1][key], rtol=2e-5)


@pytest.mark.parametrize("up,extra,label", [
    ("step", {}, "composed (fused-step kernels)"),
    ("step", dict(dropout_rate=0.1), "composed"),
    ("auto", {}, "composed")])
def test_training_path_label_follows_the_route(up, extra, label, capsys):
    """The Trainer's 'Training path:' line names the route the minibatches
    take: the fused step only where _use_fused_step holds ('step' with
    dropout and 'auto' on the CPU go composed)."""
    model = NeuralJumpODE(1, H, 1, num_moments=2, use_pallas=up,
                          device="cpu", **extra)
    times, values = trainer_data(1)
    tr = Trainer(model, make_adam(model.parameters(), LR, WD), seed=3)
    tr.train(lambda: (times, values), lambda: (times, values), n_epochs=1,
             batch_size=BS, print_every=1)
    line = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("Training path:")][0]
    assert line.startswith(f"Training path: {label} from epoch 0")


def test_run_experiment_with_step_writes_artifacts(tmp_path, capsys):
    cfg = {
        "experiment_name": "bs_step", "input_dim": 1, "hidden_dim": 16,
        "output_dim": 1, "n_hidden_layers": 1, "activation": "relu",
        "dropout_rate": 0.0, "input_scaling": "identity",
        "variance_method": "direct", "dt_ode_step": None,
        "ode_solver": "euler", "learning_rate": LR, "weight_decay": WD,
        "n_epochs": 2, "batch_size": 16, "shuffle": True, "print_every": 1,
        "device": "cpu", "ignore_first_continuity": True, "num_moments": 2,
        "moment_weights": [1.0, 10.0], "shared_network": False,
        "use_pallas": "step", "grid_walk": "auto", "seed": 0,
        "data_seed": 0,
        "data": {"process_type": "black_scholes", "n_train": 40, "n_val": 8,
                 "obs_fraction": 0.02, "cache_data": False,
                 "obs_only": True, "T": 1.0, "n_steps": 100, "mu": 0.1,
                 "sigma": 0.5, "x0": 1.0}}
    res = run_experiment(cfg, save_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert "Training path: composed (fused-step kernels)" in out
    run = tmp_path / "bs_step"
    for name in ("config.json", "model.ckpt", "history.json"):
        assert (run / name).is_file()
    hist = res["history"]
    assert len(hist["train_loss"]) == 2
    assert np.isfinite(hist["train_loss"] + hist["val_loss"]).all()


# ---------- phase 17's f32 limits against emulated TF32 products

class _Exact3xTF32(TorchFunctionMode):
    """Every plane product of the plain versions (a 2-D by 2-D matmul) in
    3xTF32: each operand split into hi = tf32(x) and lo = tf32(x - hi), the
    products lo hi + hi lo + hi hi summed exactly (float64) and rounded to
    f32 once, as accurate as f32.  The readout's dot with o2 (2-D by 1-D)
    stays f32, as in the kernels."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
                and len(args) == 2 and args[0].dim() == args[1].dim() == 2):
            a, b = args
            ah, bh = cs.tf32_round(a), cs.tf32_round(b)
            al, bl = cs.tf32_round(a - ah), cs.tf32_round(b - bh)
            return (ah.double() @ bh.double() + ah.double() @ bl.double()
                    + al.double() @ bh.double()).float()
        return func(*args, **(kwargs or {}))


def _f32_step_case(act, scale, H_=256, N_=2, L=1, rows=512, seed=0):
    """The scaled recipe's shape (two networks, one hidden layer) at a few
    hundred rows: weights uniform in +-1/sqrt(H), as torch's Linear init."""
    rng = np.random.default_rng(seed)
    lo = fs.StepLayout(L, 1, 1, 2, False)
    bound = 1.0 / np.sqrt(H_)
    W = rng.uniform(-bound, bound, (lo.Kn, lo.n_mats, H_, H_))
    V = rng.uniform(-bound, bound, (lo.Kn, lo.n_rows, H_))
    times = np.sort(rng.uniform(0.0, 1.0, (rows, N_)), axis=1)
    times[:, 0] = 0.0
    values = np.exp(rng.normal(size=(rows, N_, 1)) * 0.3)
    gy = rng.normal(size=(rows, 2 * N_ - 1, 1, 2))
    return [torch.tensor(x, dtype=torch.float32)
            for x in (W, V, times, values, gy)] + [lo]


@pytest.mark.parametrize("act,scale", [("relu", "identity"), ("tanh", "tanh"),
                                       ("elu", "sigmoid")])
def test_3xtf32_holds_the_f32_limits_and_1xtf32_does_not(act, scale):
    """chip_smoke.py phase 17's limits for rows 9-10 (forward rtol 1e-4 /
    atol 1e-5 and STEP_FWD_NORM of its norm, each dW plane and dV row within
    step_grad_rtol of its norm) tell f32-accurate products from TF32 ones:
    at the scaled shape 3xTF32 products summed exactly stay inside both
    against the plain f32 version, and the phase's control (TF32Operands,
    1xTF32) falls outside both."""
    W, V, times, values, gy, lo = _f32_step_case(act, scale)
    args = (lo, act, scale)
    y = fs.fused_step_forward_reference(W, V, times, values, *args)
    g = fs.fused_step_backward_reference(W, V, times, values, gy, *args)
    shares = {}
    for three in (True, False):
        with _Exact3xTF32() if three else cs.TF32Operands():
            ye = fs.fused_step_forward_reference(W, V, times, values, *args)
            ge = fs.fused_step_backward_reference(W, V, times, values, gy,
                                                  *args)
        assert not torch.equal(ye, y)          # the mode reached the products
        shares[three] = (cs.step_fwd_share(ye, y),
                         cs.step_bwd_share(ge, g, cs.step_grad_rtol(act)))
    assert max(shares[True]) <= 0.2, shares
    assert min(shares[False]) > 1.0, shares
