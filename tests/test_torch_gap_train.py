"""The gap loop's training pair (njode_tpu_torch/ops/gap_scan.py, rows 2-5)
and the forced-kernel model (``use_pallas=True``) held against the JAX
package on the CPU.

On the CPU the port's wrappers run the kernels' plain versions (the
residual forward and the reverse-loop backward of :class:`GapScan`); the
CUDA kernels are held against those on the card by ``chip_smoke.py``.  The
JAX side runs its Pallas kernels in interpret mode (``use_pallas=
"interpret"``), weights carried by ``state_dict_from_jax``, inputs from
numpy with a fixed seed.

Tolerances: values rtol = atol = 1e-5 (f32 summation order over up to 100
compounded substeps, as ``tests/test_torch_gap_scan.py``); gradients rtol
1e-4 / atol 1e-5 (the same orders through the reverse loop and its sums
over rows and substeps); losses rtol 2e-5 and parameters rtol 1e-4 / atol
2e-6 after Trainer steps (``tests/test_torch_training.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.ops import integrate_gap_fused as jax_integrate
from njode_tpu.utils.training import Trainer as JaxTrainer
from njode_tpu.utils.training import _resolve_grid_walk as jax_resolve
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.ops import gap_scan
from njode_tpu_torch.utils import (Trainer, make_adam, run_experiment,
                                   state_dict_from_jax)
from njode_tpu_torch.utils import training as T

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PAIRS = (("relu", "identity"), ("tanh", "tanh"), ("selu", "sigmoid"))


def make_case(seed, K, R, d_h, n_sub, dt=0.01):
    """Gaps of every kind up to the budget: zero, shorter than dt, ending
    on the grid, free; ODEFunc weights (in, out) and a cotangent."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t0 = rng.uniform(0.0, 0.2, R).astype(f32)
    t1 = t0 + rng.uniform(0.0, dt * (n_sub + 1), R).astype(f32)
    t1[0] = t0[0]
    t1[1] = t0[1] + f32(0.4 * dt)
    t0[2], t1[2] = f32(3 * dt), f32(3 * dt + dt * min(n_sub, 7))
    d_in = d_h + 3
    return {"h": (rng.normal(size=(K, R, d_h)) * 0.5).astype(f32),
            "x": rng.normal(size=(R, 1)).astype(f32), "t0": t0, "t1": t1,
            "w1": (rng.normal(size=(K, d_in, d_h)) * 0.3).astype(f32),
            "b1": (rng.normal(size=(K, d_h)) * 0.1).astype(f32),
            "w2": (rng.normal(size=(K, d_h, d_h)) * 0.3).astype(f32),
            "b2": (rng.normal(size=(K, d_h)) * 0.1).astype(f32),
            "ct": rng.normal(size=(K, R, d_h)).astype(f32),
            "dt": dt, "n_sub": n_sub}


def jax_grads(c, act, scale):
    """h(t_target) of the JAX kernel pair (interpret mode) and the
    cotangents of h, x, W1, b1, W2, b2 ((in, out) as JAX holds them)."""
    def f(h, x, w1, b1, w2, b2):
        return jax_integrate(h, x, jnp.asarray(c["t0"]), jnp.asarray(c["t1"]),
                             [{"w": w1, "b": b1}, {"w": w2, "b": b2}],
                             c["dt"], c["n_sub"], act, scale, interpret=True)
    args = [jnp.asarray(c[k]) for k in ("h", "x", "w1", "b1", "w2", "b2")]
    out, vjp = jax.vjp(f, *args)
    return [np.asarray(out)] + [np.asarray(g) for g in
                                vjp(jnp.asarray(c["ct"]))]


def port_grads(c, act, scale, fn=gap_scan.integrate_gap_fused):
    """The same through the port (the plain versions of the training pair
    on the CPU via GapScan), weights in torch's orientation."""
    t = torch.from_numpy
    h, x = t(c["h"]).requires_grad_(), t(c["x"]).requires_grad_()
    raw = [t(np.swapaxes(c["w1"], 1, 2).copy()).requires_grad_(),
           t(c["b1"]).requires_grad_(),
           t(np.swapaxes(c["w2"], 1, 2).copy()).requires_grad_(),
           t(c["b2"]).requires_grad_()]
    out, _ = fn(h, x, t(c["t0"]), t(c["t1"]), gap_scan.split_weights(raw),
                c["dt"], c["n_sub"], act, scale)
    g = torch.autograd.grad(out, [h, x, *raw], t(c["ct"]))
    return [out.detach().numpy(), g[0].numpy(), g[1].numpy(),
            g[2].transpose(1, 2).numpy(), g[3].numpy(),
            g[4].transpose(1, 2).numpy(), g[5].numpy()]


@pytest.mark.parametrize("K", [1, 2], ids=["shared", "separate"])
@pytest.mark.parametrize("n_sub", [0, 1, 10, 16, 17, 100])
def test_integrate_gap_values_and_gradients_match_jax(n_sub, K):
    """Both sides of the residual-stride switch at 16 (rows 2/4 up to 16
    substeps, 3/5 beyond), and max_substeps 0 (only the final partial
    step; nothing launches)."""
    act, scale = PAIRS[(n_sub + K) % 3]
    c = make_case(n_sub * 3 + K, K, 11, 6, n_sub)
    ours, ref = port_grads(c, act, scale), jax_grads(c, act, scale)
    np.testing.assert_allclose(ours[0], ref[0], **TOL)
    for name, a, b in zip(("h", "x", "W1", "b1", "W2", "b2"), ours[1:],
                          ref[1:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("act,scale", PAIRS)
def test_training_pair_matches_plain_autograd(act, scale):
    """GapScan's hand-written backward (the plain versions of rows 4-5)
    equals autograd through the plain substep loop, in f64 to roundoff,
    with and without checkpoints."""
    for n_sub in (9, 23):
        c = make_case(40 + n_sub, 2, 7, 5, n_sub)
        c64 = {k: (v.astype(np.float64) if isinstance(v, np.ndarray) else v)
               for k, v in c.items()}
        ours = port_grads(c64, act, scale)
        ref = port_grads(c64, act, scale, gap_scan.integrate_gap_reference)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_stored_states_and_zero_contributions():
    """The forward stores the state entering every stride-th substep, t
    bitwise as the loop reaches it; a row whose gap takes no full substep
    gets the identity cotangent and adds nothing to the weight sums."""
    c = make_case(5, 1, 6, 4, 20)
    t = torch.from_numpy
    w = gap_scan.split_weights([t(np.swapaxes(c["w1"], 1, 2).copy()),
                                t(c["b1"]),
                                t(np.swapaxes(c["w2"], 1, 2).copy()),
                                t(c["b2"])])
    args = gap_scan.substep_inputs(t(c["h"]), t(c["x"]), t(c["t0"]),
                                   t(c["t1"]), w, c["dt"])
    h_l, t_l, res_h, res_t = gap_scan.gap_train_forward_reference(
        *args, c["dt"], 20, 8, "relu", "identity")
    assert res_h.shape == (3, 1, 6, 4) and res_t.shape == (3, 6)
    h_ref, t_ref = gap_scan.gap_substeps_reference(*args, c["dt"], 20,
                                                   "relu", "identity")
    assert torch.equal(h_l, h_ref) and torch.equal(t_l, t_ref)
    _, t8 = gap_scan.gap_substeps_reference(*args, c["dt"], 8, "relu",
                                            "identity")
    assert torch.equal(res_t[1], t8)
    only = torch.zeros(1, 6, 4)
    only[0, 0] = 1.0                                  # row 0: a zero gap
    gh0, gpre, acc_t, gdh, dw1h, dw2 = gap_scan.gap_train_backward_reference(
        only, args[1], args[3], *args[4:], res_h, res_t, c["dt"], 20, 8,
        "relu", "identity")
    assert torch.equal(gh0, only)
    for x in (gpre, acc_t, gdh, dw1h, dw2):
        assert not x.any()


def test_fits_and_strides():
    assert gap_scan.residual_stride(16) == 1
    assert gap_scan.residual_stride(17) == gap_scan.CK == 8
    assert gap_scan.gap_train_fits(128)
    assert not gap_scan.gap_train_fits(129)
    assert not gap_scan.gap_train_fits(256)
    assert not gap_scan.gap_train_fits(0)


# ----------------------------------------------------------------------
# the forced-kernel model
# ----------------------------------------------------------------------

PROD = dict(input_dim=1, hidden_dim=8, output_dim=1, num_moments=2,
            shared_network=True, dt_ode_step=0.01, t_max=1.0)
DEFAULT = dict(input_dim=1, hidden_dim=8, output_dim=1, num_moments=2,
               shared_network=False, activation="tanh",
               input_scaling="tanh")
CONFIGS = {"dt-shared": PROD, "no-dt-separate": DEFAULT}
B, N = 5, 6


def bridged(seed=0, **kw):
    jax_model = JaxModel(use_pallas="interpret", **kw)
    params = jax_model.init(jax.random.PRNGKey(seed))
    port = NeuralJumpODE(**kw, use_pallas=True, device="cpu")
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=kw["num_moments"],
        shared_network=kw["shared_network"], n_hidden_layers=1))
    return jax_model, params, port


def grid_batch(seed=1):
    """Observation slots on the 100-step grid from t = 0, the last slots of
    one row padding (repeating the time before)."""
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 100), N - 1, replace=False)])
        for _ in range(B)]), axis=1)
    times = (idx * 0.01).astype(np.float32)
    values = np.exp(rng.normal(size=(B, N, 1)) * 0.3).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[-1, -2:] = False
    times[-1, -2:] = times[-1, -3]
    return times, values, mask


def loss_kw():
    return dict(ignore_first_continuity=True, moment_weights=[1.0, 10.0])


def jax_loss_and_grads(jax_model, params, times, values, mask):
    def f(p):
        return jax_model.apply_loss(p, jnp.asarray(times),
                                    jnp.asarray(values), jnp.asarray(mask),
                                    **loss_kw())
    loss, g = jax.value_and_grad(f)(params)
    return float(loss), g


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forced_apply_loss_and_gradients_match_jax(name):
    """apply_loss under use_pallas=True (gap loop with dt_ode_step: the
    training pair; without: the fused cell) and every parameter gradient,
    against the JAX model under use_pallas="interpret"."""
    kw = CONFIGS[name]
    jax_model, params, port = bridged(**kw)
    times, values, mask = grid_batch()
    loss = port.apply_loss(times, values, mask, **loss_kw())
    loss.backward()
    j_loss, j_grads = jax_loss_and_grads(jax_model, params, times, values,
                                         mask)
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=2e-5)
    ref = state_dict_from_jax(j_grads, num_moments=2,
                              shared_network=kw["shared_network"],
                              n_hidden_layers=1)
    for key, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[key].numpy(),
                                   err_msg=key, **GRAD_TOL)


def test_training_after_a_no_grad_call_still_trains_the_ode():
    """A no-grad apply (validation) fills the model's inference weight cut;
    the training step after it must cut the ODE weights differentiably
    again, or they would train with no gradient."""
    jax_model, params, port = bridged(**PROD)
    times, values, mask = grid_batch(2)
    with torch.no_grad():
        port.apply(times, values, mask)
    assert port._gap_cache is not None
    port.apply_loss(times, values, mask, **loss_kw()).backward()
    _, j_grads = jax_loss_and_grads(jax_model, params, times, values, mask)
    ref = state_dict_from_jax(j_grads, num_moments=2, shared_network=True,
                              n_hidden_layers=1)
    for key, p in port.named_parameters():
        if key.startswith("ode_func"):
            assert p.grad.abs().sum() > 0, key
            np.testing.assert_allclose(p.grad.numpy(), ref[key].numpy(),
                                       err_msg=key, **GRAD_TOL)


def test_forced_trainer_matches_jax_trainer():
    """Per-minibatch losses over three epochs of two steps (shuffle off, a
    padded last minibatch) and the parameters after, forced kernels on
    both sides."""
    rng = np.random.default_rng(3)
    n = 12
    idx = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 100), N - 1, replace=False)])
        for _ in range(n)]), axis=1)
    times = (idx * 0.01).astype(np.float32)
    values = np.exp(rng.normal(size=(n, N, 1)) * 0.3).astype(np.float32)
    jax_model = JaxModel(use_pallas="interpret", **PROD)
    jt = JaxTrainer(jax_model, jax_make_adam(1e-3, 5e-4),
                    ignore_first_continuity=True, moment_weights=[1.0, 10.0],
                    seed=5)
    init = jax.tree_util.tree_map(np.asarray, jt.params)
    ref = jt.train(lambda: (jnp.asarray(times), jnp.asarray(values)),
                   n_epochs=3, batch_size=8, shuffle=False, print_every=1)
    port = NeuralJumpODE(**PROD, use_pallas=True, device="cpu")
    port.load_state_dict(state_dict_from_jax(init, num_moments=2,
                                             shared_network=True,
                                             n_hidden_layers=1))
    tr = Trainer(port, make_adam(port.parameters(), 1e-3, 5e-4),
                 ignore_first_continuity=True, moment_weights=[1.0, 10.0],
                 seed=5)
    hist = tr.train(lambda: (times, values), n_epochs=3, batch_size=8,
                    shuffle=False, print_every=1)
    np.testing.assert_allclose(hist["train_loss"], ref["train_loss"],
                               rtol=2e-5)
    want = state_dict_from_jax(jt.params, num_moments=2, shared_network=True,
                               n_hidden_layers=1)
    for key, val in port.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[key].numpy(),
                                   err_msg=key, rtol=1e-4, atol=2e-6)


def _config(tmp_path, **over):
    cfg = {
        "experiment_name": "forced", "input_dim": 1, "hidden_dim": 8,
        "output_dim": 1, "n_hidden_layers": 1, "activation": "relu",
        "dropout_rate": 0.0, "input_scaling": "identity",
        "variance_method": "direct", "dt_ode_step": 0.01,
        "ode_solver": "euler", "learning_rate": 1e-3, "weight_decay": 5e-4,
        "n_epochs": 2, "batch_size": 8, "shuffle": True, "print_every": 1,
        "device": "cpu", "ignore_first_continuity": True, "num_moments": 2,
        "moment_weights": [1.0, 15.0], "shared_network": True,
        "use_pallas": True, "grid_walk": "off", "seed": 0, "data_seed": 0,
        "data": {"process_type": "black_scholes", "n_train": 16, "n_val": 8,
                 "obs_fraction": 0.1, "cache_data": False, "obs_only": True,
                 "T": 1.0, "n_steps": 100, "mu": 0.1, "sigma": 0.5,
                 "x0": 1.0}}
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("over,label", [
    ({}, "composed (forced gap-loop kernels)"),
    (dict(dt_ode_step=None, shared_network=False),
     "composed (forced fused Euler cell)")])
def test_run_experiment_with_forced_kernels(tmp_path, capsys, over, label):
    res = run_experiment(_config(tmp_path, **over), save_dir=str(tmp_path))
    assert f"Training path: {label} from epoch 0" in capsys.readouterr().out
    hist = res["history"]
    assert len(hist["train_loss"]) == 2
    assert np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
    for name in ("config.json", "model.ckpt", "history.json"):
        assert (tmp_path / "forced" / name).is_file()


def test_grid_walk_policy_resolves_true_as_jax():
    """use_pallas True walks under "auto" where the JAX package's force
    policy does on its accelerator (the port's: cuda), for an aligned,
    eligible config; off the accelerator it resolves off on both."""
    cfg = _config(None, grid_walk="auto")
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert T._resolve_grid_walk(cfg, cuda, True) is True
    assert jax_resolve(cfg, platform="tpu", use_pallas_cfg=True) is True
    assert T._resolve_grid_walk(cfg, cpu, True) is False
    assert jax_resolve(cfg, platform="cpu", use_pallas_cfg=True) is False
    off = dict(cfg, dt_ode_step=0.03)
    assert T._resolve_grid_walk(off, cuda, True) is False
    assert jax_resolve(off, platform="tpu", use_pallas_cfg=True) is False


def test_interpret_still_raises():
    with pytest.raises(NotImplementedError, match="on the CPU use True"):
        NeuralJumpODE(**PROD, use_pallas="interpret", device="cpu")
    with pytest.raises(NotImplementedError, match="interpret mode"):
        run_experiment(_config(None, use_pallas="interpret"), save_dir="x")
