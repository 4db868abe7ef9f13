"""Mixed precision (``compute_dtype``) in the port, held against the JAX
package's on the CPU (``tests/test_bf16.py``, ``tests/test_fused_step.py``'s
bf16 case).

Weights come from the JAX init through ``state_dict_from_jax``; inputs from
numpy with a fixed seed.  The networks run in bf16 or fp16, the parameters,
the solver's carry and the outputs stay f32.  Tolerances (never looser than
the JAX package's own for its bf16 fused step, rtol = atol = 3e-2 forward
and 0.25 on gradients):

* the composed path against the JAX composed path: predictions rtol = atol
  = 1e-2 (a product or sum summed in another order lands on the other side
  of a bf16 rounding: one bf16 ulp, 2^-8 relative, carried on), the loss
  of those predictions rtol 1e-2, each parameter gradient within 3e-2 of
  its norm, or within twice the JAX bf16 gradient's own distance from the
  JAX f32 gradient where that is larger (XLA rounds each step of an
  activation such as selu to bf16, torch computes the activation in f32 and
  rounds once: with two selu layers the JAX bf16 gradients sit about 5%
  from its f32 ones, the port's about 1%);
* each package against its own f32 model: within 0.05, scaled by
  max(|f32|, 1) (``tests/test_bf16.py``'s bound);
* the fused step's bf16 plain versions against the JAX kernels in
  interpret mode: Y rtol = atol = 1e-2, each dW plane and dV row within
  3e-2 of its norm (both sum bf16-exact products in f32, in other orders);
* ``run_experiment`` under ``"step"`` against the JAX ``"step-interpret"``
  run on the same data and weights: per-epoch losses rtol 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.models import nj_ode_loss_dense as jax_loss
from njode_tpu.ops import fused_step as jfs
from njode_tpu.utils import training as jax_training
from njode_tpu_torch import NeuralJumpODE, NJODEFilter
from njode_tpu_torch.models import nj_ode_loss_dense
from njode_tpu_torch.models import jump_ode as port_jump_ode
from njode_tpu_torch.ops import fused_cell, gap_scan, walk_scan, walk_train
from njode_tpu_torch.ops import fused_step as fs
from njode_tpu_torch.ops import train_kernel as tk
from njode_tpu_torch.utils import (Trainer, make_adam, run_experiment,
                                   state_dict_from_jax)
from njode_tpu_torch.utils import training as port_training

FWD_TOL = dict(rtol=1e-2, atol=1e-2)
LOSS_RTOL = 1e-2
GRAD_NORM_TOL = 3e-2
H, N, B = 12, 5, 7
BF16, FP16 = torch.bfloat16, torch.float16


def jax_model_kw(cfg):
    kw = dict(input_dim=1, hidden_dim=H, output_dim=1, num_moments=2,
              activation="tanh", use_pallas=False)
    kw.update(cfg)
    return kw


def bridged(seed=0, **cfg):
    kw = jax_model_kw(cfg)
    jax_model = JaxModel(**kw)
    kw.pop("use_pallas")
    params = jax_model.init(jax.random.PRNGKey(seed))
    port = NeuralJumpODE(**kw, use_pallas=False, device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=kw["num_moments"],
        shared_network=kw.get("shared_network", False),
        n_hidden_layers=kw.get("n_hidden_layers", 1)))
    return jax_model, params, port


def batch(seed=0, grid=None):
    """B trajectories on [0, 1] from t = 0, two of them padded at the end;
    with ``grid`` every time on {g grid} and strictly increasing."""
    rng = np.random.default_rng(seed)
    if grid is None:
        times = np.sort(rng.uniform(0.0, 1.0, (B, N)), axis=1)
    else:
        cells = np.sort(np.stack([rng.choice(np.arange(1, int(round(1 / grid))),
                                             N - 1, replace=False)
                                  for _ in range(B)]), axis=1)
        times = np.concatenate([np.zeros((B, 1)), cells * grid], axis=1)
    times = times.astype(np.float32)
    times[:, 0] = 0.0
    values = np.exp(rng.normal(size=(B, N, 1)) * 0.3).astype(np.float32)
    mask = np.ones((B, N), bool)
    if grid is None:
        for b, n in ((1, 3), (4, 2)):
            mask[b, n:] = False
            times[b, n:] = times[b, n - 1]
            values[b, n:] = values[b, n - 1]
    return times, values, mask


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def assert_grads_close(port, jax_grads, K, shared, L=1, jax_f32_grads=None):
    """Each parameter's gradient within GRAD_NORM_TOL of the JAX one's norm,
    or within twice the JAX gradient's distance from ``jax_f32_grads``
    where that is larger."""
    bridge = dict(num_moments=K, shared_network=shared, n_hidden_layers=L)
    ref = state_dict_from_jax(jax_grads, **bridge)
    f32 = (state_dict_from_jax(jax_f32_grads, **bridge)
           if jax_f32_grads is not None else None)
    named = dict(port.named_parameters())
    for key, g in ref.items():
        ours = named[key].grad
        assert ours.dtype == torch.float32, key
        tol = GRAD_NORM_TOL if f32 is None else max(
            GRAD_NORM_TOL, 2 * _rel(g, f32[key]))
        assert _rel(ours, g) <= tol, (key, _rel(ours, g), tol)


# ------------------------------------------------- compute_dtype parsing

@pytest.mark.parametrize("name,want", [
    (None, None), ("float32", None), ("none", None), ("NONE", None),
    ("bfloat16", BF16), ("bf16", BF16), ("float16", FP16), ("fp16", FP16),
    (BF16, BF16), (FP16, FP16)])
def test_compute_dtype_names(name, want):
    """The JAX package's names (njode_tpu/models/jump_ode.py:150-157), and
    the torch dtypes as given; the parameters stay float32."""
    model = NeuralJumpODE(1, 8, 1, compute_dtype=name, device="cpu")
    assert model.compute_dtype == want
    assert model.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert JaxModel(input_dim=1, hidden_dim=8, output_dim=1,
                    compute_dtype=name if isinstance(name, str) or name is None
                    else {BF16: "bf16", FP16: "fp16"}[name]).compute_dtype \
        == {None: None, BF16: jnp.bfloat16, FP16: jnp.float16}[want]


@pytest.mark.parametrize("name", ["float8", "int8", torch.float64])
def test_unknown_compute_dtypes_raise(name):
    with pytest.raises(ValueError, match="Unknown compute_dtype"):
        NeuralJumpODE(1, 8, 1, compute_dtype=name, device="cpu")


# ------------------------------------------- the composed path against JAX

COMPOSED = {
    "euler": dict(),
    "euler-dt": dict(dt_ode_step=0.02),
    "heun-dt": dict(dt_ode_step=0.02, ode_solver="heun"),
    "rk4-dt-shared": dict(dt_ode_step=0.02, ode_solver="rk4",
                          shared_network=True),
    "grid-walk": dict(dt_ode_step=0.02, grid_walk=True, activation="relu"),
    "shared-two-layers": dict(shared_network=True, n_hidden_layers=2,
                              activation="selu", input_scaling="tanh"),
}


@pytest.mark.parametrize("cdt", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", list(COMPOSED))
def test_composed_apply_and_gradients_match_jax(name, cdt):
    """apply and the gradients of nj_ode_loss_dense, composed (use_pallas
    False: the XLA loop, the plain walk), against the JAX model at the
    same compute dtype."""
    cfg = dict(COMPOSED[name], compute_dtype=cdt)
    jax_model, params, port = bridged(**cfg)
    times, values, mask = batch(
        1, grid=0.02 if cfg.get("grid_walk") else None)
    tj, vj, mj = (jnp.asarray(a) for a in (times, values, mask))
    ref = jax_model.apply(params, tj, vj, mj)
    ours = port.apply(times, values, mask)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **FWD_TOL)

    def jax_grad(model):
        def jl(p):
            pr, pb = model.apply(p, tj, vj, mj)
            return jax_loss(vj, pr, pb, mj, moment_weights=[1.0, 10.0])
        return jax.value_and_grad(jl)(params)
    v_ref, g_ref = jax_grad(jax_model)
    jax_f32 = JaxModel(**dict(jax_model_kw(cfg), compute_dtype=None))
    loss = port.apply_loss(times, values, mask, moment_weights=[1.0, 10.0])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_ref), rtol=LOSS_RTOL)
    assert_grads_close(port, g_ref, 2, cfg.get("shared_network", False),
                       cfg.get("n_hidden_layers", 1), jax_grad(jax_f32)[1])


def _f32_twin(port):
    twin = NeuralJumpODE(1, port.hidden_dim, 1, num_moments=2,
                         activation=port.activation,
                         dt_ode_step=port.dt_ode_step, use_pallas=False,
                         device="cpu")
    twin.load_state_dict(port.state_dict())
    return twin


@pytest.mark.parametrize("dt_ode_step", [None, 0.02])
def test_bf16_close_to_f32_in_both_packages(dt_ode_step):
    """tests/test_bf16.py:26-40 for each package: hidden 64, tanh, the bf16
    model within 0.05 of the same weights in f32, scaled by max(|f32|, 1),
    its outputs f32."""
    jax_model, params, port = bridged(hidden_dim=64, dt_ode_step=dt_ode_step,
                                      compute_dtype="bfloat16")
    jax_f32 = JaxModel(input_dim=1, hidden_dim=64, output_dim=1,
                       num_moments=2, activation="tanh",
                       dt_ode_step=dt_ode_step, use_pallas=False)
    times, values, mask = batch(2)
    tj, vj, mj = (jnp.asarray(a) for a in (times, values, mask))
    with torch.no_grad():
        pairs = [(port.apply(times, values, mask),
                  _f32_twin(port).apply(times, values, mask)),
                 (jax_model.apply(params, tj, vj, mj),
                  jax_f32.apply(params, tj, vj, mj))]
    for low, full in pairs:
        for a, b in zip(low, full):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == np.float32
            assert np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)) < 0.05


def test_serving_runs_composed_bf16_and_matches_jax():
    """predict_at and NJODEFilter of a bf16 model (the production shape:
    shared, dt_ode_step 0.01) run the composed bf16 route, launch nothing
    and return f32 (tests/test_bf16.py:71-85), close to the JAX model's."""
    jax_model, params, port = bridged(hidden_dim=50, shared_network=True,
                                      dt_ode_step=0.01, activation="relu",
                                      compute_dtype="bf16")
    port.use_pallas = "auto"
    assert not port._use_gap_scan(inference=True)
    times, values, mask = batch(3)
    query = np.sort(np.random.default_rng(4).uniform(0.0, 1.0, (B, 6)),
                    axis=1).astype(np.float32)
    gap_scan.LAUNCHES = 0
    out = port.predict_at(times, values, query, mask)
    ref = jax_model.predict_at(params, jnp.asarray(times), jnp.asarray(values),
                               jnp.asarray(query), mask=jnp.asarray(mask))
    assert out["mean"].dtype == torch.float32
    np.testing.assert_allclose(out["raw"].numpy(), np.asarray(ref["raw"]),
                               **FWD_TOL)
    f = NJODEFilter(port)
    state = f.init_state(B)
    for s in range(N):
        state = f.update(state, times[:, s], values[:, s])
    pred = f.predict(state, np.full(B, 1.0, np.float32))
    assert pred["mean"].dtype == torch.float32
    assert torch.isfinite(pred["raw"]).all()
    assert gap_scan.LAUNCHES == 0


# ---------------------------------- the fused step's bf16 plain versions

def _packed_case(H_, N_, shared, seed):
    K = 2
    cfg = dict(input_dim=1, hidden_dim=H_, output_dim=1, num_moments=K,
               shared_network=shared)
    jax_model = JaxModel(use_pallas="step-interpret", **cfg)
    params = jax_model.init(jax.random.PRNGKey(seed))
    port = NeuralJumpODE(**cfg, use_pallas="step", compute_dtype="bfloat16",
                         device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=K, shared_network=shared, n_hidden_layers=1))
    rng = np.random.default_rng(seed + 100)
    times = np.sort(rng.uniform(0.0, 1.0, (B, N_)), axis=1).astype(np.float32)
    times[:, 0] = 0.0
    values = (rng.normal(size=(B, N_, 1)) * 0.3 + 1.0).astype(np.float32)
    cot = [rng.normal(size=(B, N_, 1, K)).astype(np.float32)
           for _ in range(2)]
    cot[1][:, 0] = 0.0
    return params, port, times, values, cot


@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
@pytest.mark.parametrize("N_", [1, 2, 4])
@pytest.mark.parametrize("H_", [8, 24])
def test_fused_step_bf16_plain_versions_match_jax(H_, N_, shared):
    """fused_step_apply with compute_dtype bf16 (the plain versions on CPU
    tensors, FusedStep's explicit backward) against the JAX
    fused_step_apply_packed in interpret mode with compute_dtype bf16:
    predictions, then dW and dV for the same output cotangents, cut from
    the JAX package's padded planes."""
    params, port, times, values, cot = _packed_case(H_, N_, shared, H_ + N_)
    kw = dict(num_moments=2, hidden_dim=H_, shared_network=shared)
    jW, jV, jbo2 = jfs.pack_params(params, **kw)
    jargs = dict(activation="relu", input_scaling="identity",
                 compute_dtype=jnp.bfloat16, interpret=True, **kw)
    jargs.pop("hidden_dim")

    def jax_apply(W, V):
        return jfs.fused_step_apply_packed(W, V, jbo2, jnp.asarray(times),
                                           jnp.asarray(values), **jargs)
    ref, vjp = jax.vjp(jax_apply, jW, jV)
    if N_ == 1:
        cot[1][:] = 0.0
    dW_ref, dV_ref = vjp(tuple(jnp.asarray(c) for c in cot))
    W, V, bo2 = fs.pack_params(port)
    W = W.detach().requires_grad_()
    V = V.detach().requires_grad_()
    ours = fs.fused_step_apply_packed(W, V, bo2.detach(),
                                      torch.tensor(times),
                                      torch.tensor(values),
                                      **port._step_kwargs())
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **FWD_TOL)
    # preds_before is a constant zero at N 1
    outs = ours if N_ > 1 else ours[:1]
    dW, dV = torch.autograd.grad(outs, [W, V],
                                 [torch.tensor(c) for c in cot][:len(outs)])
    assert dW.dtype == dV.dtype == torch.float32
    lo = fs.layout_of(port)
    dW_ref = torch.tensor(np.asarray(dW_ref)[:, :, :H_, :H_])
    dV_ref = torch.tensor(np.asarray(dV_ref)[:, :lo.n_rows, :H_])
    for ours_, ref_ in ((dW, dW_ref), (dV, dV_ref)):
        for i in range(ours_.shape[0]):
            for j in range(ours_.shape[1]):
                rel = float((ours_[i, j] - ref_[i, j]).norm()
                            / ref_[i, j].norm().clamp_min(1e-30))
                assert rel <= GRAD_NORM_TOL, (i, j, rel)


def test_fused_step_bf16_loss_matches_jax():
    """fused_step_loss in bf16 (value and parameter gradients) against the
    JAX lane-space fused_step_loss in interpret mode."""
    params, port, times, values, _ = _packed_case(24, 4, False, 5)
    mask = np.ones(times.shape, bool)
    kw = dict(ignore_first_continuity=True, moment_weights=[1.0, 10.0])
    v_ref, g_ref = jax.value_and_grad(lambda p: jfs.fused_step_loss(
        p, jnp.asarray(times), jnp.asarray(values), jnp.asarray(mask),
        num_moments=2, hidden_dim=24, activation="relu",
        input_scaling="identity", compute_dtype=jnp.bfloat16, interpret=True,
        **kw))(params)
    loss = fs.fused_step_loss_packed(*fs.pack_params(port),
                                     torch.tensor(times),
                                     torch.tensor(values), torch.tensor(mask),
                                     **kw, **port._step_kwargs())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_ref), rtol=LOSS_RTOL)
    assert_grads_close(port, g_ref, 2, False)


def test_bf16_plain_backward_is_its_forwards_explicit_backward():
    """fused_step_backward_reference in bf16 against autograd through
    fused_step_forward_reference in bf16 on bf16-exact weights: autograd
    rounds the cotangent to bf16 where it passes each cast back, the
    explicit backward rounds the operands of its products (JAX's ``mm``
    and ``outer``), and the two agree within 3e-2 of each plane's norm;
    the bf16 mode differs from the f32 mode."""
    params, port, times, values, _ = _packed_case(24, 3, False, 8)
    W, V, _ = fs.pack_params(port)
    W = W.detach().to(BF16).float().requires_grad_()
    V = V.detach().requires_grad_()
    t, x = torch.tensor(times), torch.tensor(values)
    lo = fs.layout_of(port)
    Y = fs.fused_step_forward_reference(W, V, t, x, lo, "relu", "identity",
                                        BF16)
    Y32 = fs.fused_step_forward_reference(W, V, t, x, lo, "relu", "identity")
    assert not torch.equal(Y, Y32)
    gy = torch.tensor(np.random.default_rng(2).normal(
        size=tuple(Y.shape)).astype(np.float32))
    ref = torch.autograd.grad(Y, [W, V], gy)
    ours = fs.fused_step_backward_reference(W.detach(), V.detach(), t, x, gy,
                                            lo, "relu", "identity", BF16)
    for a, b in zip(ours, ref):
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                rel = float((a[i, j] - b[i, j]).norm()
                            / b[i, j].norm().clamp_min(1e-30))
                assert rel <= GRAD_NORM_TOL, (i, j, rel)


def test_fused_step_refuses_float16():
    _, port, times, values, _ = _packed_case(8, 2, False, 1)
    W, V, bo2 = fs.pack_params(port)
    kw = dict(port._step_kwargs(), compute_dtype=FP16)
    with pytest.raises(ValueError, match="bfloat16"):
        fs.fused_step_apply_packed(W, V, bo2, torch.tensor(times),
                                   torch.tensor(values), **kw)


# ---------------------------------------------------------------- routing

def _counts():
    return (gap_scan.LAUNCHES, dict(gap_scan.LAUNCHES_RES_FWD),
            dict(gap_scan.LAUNCHES_BWD), fused_cell.LAUNCHES,
            walk_scan.LAUNCHES_FWD, walk_scan.LAUNCHES_BWD, fs.LAUNCHES_FWD,
            fs.LAUNCHES_BWD, fs.LAUNCHES_FWD_BF16, fs.LAUNCHES_BWD_BF16,
            tk.LAUNCHES, walk_train.LAUNCHES)


def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return orig(*a, **k)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("cdt", ["bfloat16", "float16"])
@pytest.mark.parametrize("up", [True, "auto", "step"])
def test_routing_under_a_compute_dtype(up, cdt, monkeypatch):
    """As the JAX package's _pallas_on / _use_walk_kernel / _use_fused_step
    decide: under a compute dtype no gap, cell or walk route, whatever the
    policy; "step" takes the fused step in bf16 and not in fp16.  The
    routes are spied on while apply_loss runs forward and backward with and
    without dt_ode_step (the grid walk on), and under no_grad; no launch
    counter moves on CPU tensors."""
    before = _counts()
    calls = []
    for mod, name in ((fs.FusedStep, "apply"),
                      (port_jump_ode, "integrate_gap_fused"),
                      (fused_cell, "ode_euler_fused"),
                      (walk_scan, "walk_gaps_fused")):
        _spy(monkeypatch, mod, name, calls)
    kw = dict(input_dim=1, output_dim=1, num_moments=2, use_pallas=up,
              compute_dtype=cdt, device="cpu")
    step = NeuralJumpODE(hidden_dim=8, **kw)
    walk = NeuralJumpODE(hidden_dim=8, dt_ode_step=0.02, grid_walk=True, **kw)
    for m in (step, walk):
        assert not m._use_fused() and not m._use_walk_kernel()
        assert not m._use_gap_scan() and not m._use_gap_scan(inference=True)
        assert m._forced_route() is None
    takes_step = up == "step" and cdt == "bfloat16"
    assert step._use_fused_step(N, B) == takes_step
    times, values, mask = batch(5, grid=0.02)
    for m in (step, walk):
        m.apply_loss(times, values, mask).backward()
        with torch.no_grad():
            m.apply(times, values, mask)
    assert calls == ["apply"] * 2 * takes_step
    assert _counts() == before


# ---------------------------------------------------------------- trainer

def _train_data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 100), N - 1, replace=False)])
        for _ in range(n)]), axis=1)
    times = (idx * 0.01).astype(np.float32)
    values = np.exp(rng.normal(size=(n, N, 1)) * 0.3).astype(np.float32)
    return times, values


@pytest.mark.parametrize("up", [False, "step"])
def test_trainer_keeps_f32_master_params_and_adam_state(up, capsys):
    """tests/test_bf16.py:43-68 through the port's Trainer: a bf16 model
    (composed, and the fused step's bf16 plain versions) trains at lr 1e-2
    for 60 full-batch steps, the loss falls by more than half, and the
    parameters, their gradients and Adam's moments stay float32."""
    model = NeuralJumpODE(1, 32, 1, num_moments=2, compute_dtype="bfloat16",
                          use_pallas=up, device="cpu")
    opt = make_adam(model.parameters(), 1e-2)
    tr = Trainer(model, opt, moment_weights=[1.0, 10.0])
    times, values = _train_data(32)
    hist = tr.train(lambda: (times, values), n_epochs=60, batch_size=None,
                    print_every=100)
    label = "composed (fused-step kernels)" if up else "composed"
    assert f"Training path: {label} from" in capsys.readouterr().out
    assert hist["train_loss"][-1] < hist["train_loss"][0] / 2
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    for s in opt.state_dict()["state"].values():
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


@pytest.mark.parametrize("twin", ["run", "walk"])
def test_whole_run_kernels_refuse_a_compute_dtype(twin):
    """The whole-run kernels compute float32 only (JAX Trainer :400, :489):
    use_train_kernel=True on a bf16 model raises "float32 only" (before,
    their check read the parameters' dtype and a bf16 model trained in f32
    inside the kernel), and "auto" goes composed."""
    kw = dict(num_moments=2, compute_dtype="bfloat16", device="cpu")
    if twin == "walk":
        kw.update(shared_network=True, dt_ode_step=0.01, grid_walk=True)
    model = NeuralJumpODE(1, 16, 1, **kw)
    forced = Trainer(model, ignore_first_continuity=True,
                     use_train_kernel=True)
    check = (forced._walk_train_check if twin == "walk"
             else forced._train_kernel_check)
    with pytest.raises(ValueError, match="float32 only"):
        check(16, N)
    f32 = NeuralJumpODE(1, 16, 1, **dict(kw, compute_dtype=None))
    (Trainer(f32, ignore_first_continuity=True)._walk_train_check
     if twin == "walk" else Trainer(f32, ignore_first_continuity=True)
     ._train_kernel_check)(16, N)
    auto = Trainer(model, ignore_first_continuity=True,
                   use_train_kernel="auto")
    auto.device = torch.device("cuda")      # stands in for the card
    assert auto._use_kernel(16, N) is False


# -------------------------------------------------------- run_experiment

def _scaled_config(tmp_path, n_epochs, use_pallas="step"):
    """A small scaled-recipe config (two networks, no dt_ode_step, N 2,
    relu / identity) with compute_dtype bfloat16."""
    return {
        "experiment_name": "bs_bf16", "input_dim": 1, "hidden_dim": 16,
        "output_dim": 1, "n_hidden_layers": 1, "activation": "relu",
        "dropout_rate": 0.0, "input_scaling": "identity",
        "variance_method": "direct", "dt_ode_step": None,
        "ode_solver": "euler", "learning_rate": 1e-3, "weight_decay": 5e-4,
        "n_epochs": n_epochs, "batch_size": 16, "shuffle": False,
        "print_every": 1, "device": "cpu", "ignore_first_continuity": True,
        "num_moments": 2, "moment_weights": [1.0, 10.0],
        "shared_network": False, "extended_moments": False,
        "compute_dtype": "bfloat16", "use_pallas": use_pallas,
        "grid_walk": "auto", "train_kernel_mxu": "float32", "seed": 3,
        "data_seed": 0,
        "data": {"process_type": "black_scholes", "n_train": 40, "n_val": 12,
                 "obs_fraction": 0.02, "cache_data": False, "obs_only": True,
                 "T": 1.0, "n_steps": 100, "mu": 0.1, "sigma": 0.5,
                 "x0": 1.0}}


def _fixed_loaders(n_slots=2):
    """The same (times, values) for both packages' run_experiment: 40
    training and 12 validation trajectories on the 100-step grid."""
    def data(n, seed):
        rng = np.random.default_rng(seed)
        idx = np.sort(np.stack([np.concatenate(
            [[0], rng.choice(np.arange(1, 101), n_slots - 1, replace=False)])
            for _ in range(n)]), axis=1)
        return ((idx * 0.01).astype(np.float32),
                np.exp(rng.normal(size=(n, n_slots, 1)) * 0.3)
                .astype(np.float32))
    return data(40, 0), data(12, 1)


def test_run_experiment_bf16_step_matches_jax_and_resumes(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """run_experiment of a bf16 config under "step" (the fused step's bf16
    plain versions) against the JAX package's run_experiment under
    "step-interpret" (its bf16 kernels in interpret mode) on the same data
    and initial weights, shuffle off: per-epoch train and validation losses
    at rtol 1e-2.  The saved config carries compute_dtype, and a second
    call resumes the bf16 model from its checkpoint."""
    (tt, tv), (vt, vv) = _fixed_loaders()
    monkeypatch.setattr(jax_training, "create_data_loaders", lambda **kw: (
        lambda: (jnp.asarray(tt), jnp.asarray(tv)),
        lambda: (jnp.asarray(vt), jnp.asarray(vv))))
    monkeypatch.setattr(port_training, "create_data_loaders", lambda **kw: (
        lambda: (tt, tv), lambda: (vt, vv)))
    cfg = _scaled_config(tmp_path, 2)
    jax_cfg = dict(cfg, use_pallas="step-interpret", device="cpu")
    ref = jax_training.run_experiment(jax_cfg, save_dir=str(tmp_path / "jax"))
    init = JaxModel(input_dim=1, hidden_dim=16, output_dim=1,
                    num_moments=2).init(
        jax.random.fold_in(jax.random.PRNGKey(cfg["seed"]), 0))
    sd = state_dict_from_jax(init, num_moments=2, shared_network=False,
                             n_hidden_layers=1)
    built = []

    class FromJaxInit(NeuralJumpODE):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.load_state_dict(sd)
            built.append(self)
    monkeypatch.setattr(port_training, "NeuralJumpODE", FromJaxInit)
    res = run_experiment(cfg, save_dir=str(tmp_path))
    assert "Training path: composed (fused-step kernels)" in \
        capsys.readouterr().out
    assert built[0].compute_dtype == BF16
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(res["history"][key],
                                   ref["history"][key], rtol=1e-2)
    saved = (tmp_path / "bs_bf16" / "config.json").read_text()
    assert '"compute_dtype": "bfloat16"' in saved
    res3 = run_experiment(_scaled_config(tmp_path, 3), save_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert "Resuming from epoch 2" in out
    assert built[1].compute_dtype == BF16
    assert res3["history"]["train_loss"][:2] == res["history"]["train_loss"]
    assert len(res3["history"]["train_loss"]) == 3


def test_run_experiment_runs_composed_bf16(tmp_path, capsys):
    """A bf16 config under "auto" on the CPU: composed (the whole-run
    kernel declines a compute dtype), finite losses; "train" refuses it."""
    res = run_experiment(_scaled_config(tmp_path, 1, use_pallas="auto"),
                         save_dir=str(tmp_path))
    assert "Training path: composed from epoch 0" in capsys.readouterr().out
    assert np.isfinite(res["history"]["train_loss"]).all()
    with pytest.raises(ValueError, match="float32 only"):
        run_experiment(dict(_scaled_config(tmp_path, 1, use_pallas="train"),
                            experiment_name="bs_bf16_train"),
                       save_dir=str(tmp_path))


def test_bf16_loss_helper_agrees_with_apply():
    """apply_loss of a bf16 model equals nj_ode_loss_dense of its apply."""
    _, _, port = bridged(compute_dtype="bf16", dt_ode_step=0.02)
    times, values, mask = batch(6)
    with torch.no_grad():
        loss = port.apply_loss(times, values, mask)
        preds, before = port.apply(times, values, mask)
        direct = nj_ode_loss_dense(torch.tensor(values), preds, before,
                                   torch.tensor(mask))
    assert torch.equal(loss, direct)


# ------------- the ratio test of chip_smoke.py phase 24 (rows 9b-10b)

def _ratio_case(H_, N_, L, act, scale, rows=512, seed=0):
    """Fused-step inputs for two networks: weights uniform in +-1/sqrt(H),
    as torch's Linear init, sorted times, log-normal values, normal output
    cotangents."""
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


@pytest.mark.parametrize("H_,N_,L,act,scale", [
    (256, 2, 1, "relu", "identity"), (32, 10, 2, "tanh", "tanh"),
    (50, 10, 1, "elu", "sigmoid")])
def test_step_ratio_test_tells_the_rounding_points(H_, N_, L, act, scale):
    """chip_smoke.step_ratio_share, phase 24's ratio test (each of Y, the
    dW planes and the dV rows within 0.1 of the bf16 mode's own distance
    from f32, normwise): the plain bf16 version passes it against itself
    in another summation order (its hidden units permuted, which changes
    the order of every sum and no rounding point), and a mode that rounds
    only the weights, not the activation operands, fails it, as does the
    f32 mode."""
    W, V, times, values, gy, lo = _ratio_case(H_, N_, L, act, scale)
    args = (lo, act, scale)
    perm = torch.randperm(H_, generator=torch.Generator().manual_seed(1))
    inv = torch.argsort(perm)
    Wp = W[:, :, perm][:, :, :, perm].contiguous()
    Vp = V[:, :, perm].contiguous()
    bf = torch.bfloat16
    y = fs.fused_step_forward_reference(W, V, times, values, *args, bf)
    g = fs.fused_step_backward_reference(W, V, times, values, gy, *args, bf)
    y32 = fs.fused_step_forward_reference(W, V, times, values, *args)
    g32 = fs.fused_step_backward_reference(W, V, times, values, gy, *args)
    yp = fs.fused_step_forward_reference(Wp, Vp, times, values, *args, bf)
    dWp, dVp = fs.fused_step_backward_reference(Wp, Vp, times, values, gy,
                                                *args, bf)
    gp = (dWp[:, :, inv][:, :, :, inv], dVp[:, :, inv])
    assert not torch.equal(yp, y)               # another order, other bits
    assert cs.step_ratio_share(yp, y, y32) <= 0.5
    assert cs.step_ratio_share(gp, g, g32) <= 0.5
    Wr = W.to(bf).float()                       # rounds the weights only
    yw = fs.fused_step_forward_reference(Wr, V, times, values, *args)
    gw = fs.fused_step_backward_reference(Wr, V, times, values, gy, *args)
    assert cs.step_ratio_share(yw, y, y32) > 2.0
    assert cs.step_ratio_share(gw, g, g32) > 2.0
    assert cs.step_ratio_share(y32, y, y32) > 2.0
    assert cs.step_ratio_share(g32, g, g32) > 2.0
