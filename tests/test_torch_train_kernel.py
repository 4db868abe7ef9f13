"""The whole-run training kernel's plain version
(njode_tpu_torch/ops/train_kernel.py) held against the JAX package's
``fused_train_run`` on the CPU, and against the port's own composed
trainer.

On the CPU the wrapper runs the plain version; the CUDA kernel
(``ops/csrc/train_run.cu``) is held against that plain version on the card
by ``chip_smoke.py``.  The JAX kernel runs in Pallas interpret mode, as
tests/test_train_kernel.py runs it, at its sizes (H = 12, N = 5, BS = 16).
Inputs and weights come from numpy and JAX's init through the weight
bridge.

Tolerances are the JAX package's own for its kernel against optax
(tests/test_train_kernel.py:117-121): per-step losses rtol 2e-5; params,
Adam m and v after the steps rtol 1e-4 / atol 2e-6 (f32 sums in other
orders; Adam's normalised step carries their rounding into the params).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.ops import train_kernel as jtk
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.ops import train_kernel as tk
from njode_tpu_torch.utils import state_dict_from_jax

H, N, BS = 12, 5, 16
LOSS_TOL = dict(rtol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=2e-6)
LR, WD = 1e-3, 5e-4

# K, variance_method, activation, input_scaling, G, padded last minibatch,
# resume split (None = one call)
CASES = {
    "dual-direct": (2, "direct", "relu", "identity", 3, True, None),
    "dual-second-moment": (2, "second_moment", "relu", "identity", 3, False,
                           None),
    "mean-only": (1, "direct", "relu", "identity", 3, True, None),
    "resume": (2, "direct", "relu", "identity", 4, True, 2),
    "tanh-tanh": (2, "direct", "tanh", "tanh", 2, False, None),
    "selu-identity": (2, "second_moment", "selu", "identity", 2, True, None),
}


def make_data(G, padded, seed=0):
    """G minibatches of obs-only-style BS rows: N sorted grid times starting
    at 0 and lognormal values; with ``padded`` the last 5 rows are padding
    (valid 0) that repeat row 0, as the Trainer pads."""
    rng = np.random.default_rng(seed)
    rows = G * BS
    idx = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 100), N - 1, replace=False)])
        for _ in range(rows)]), axis=1)
    times = (idx * 0.01).astype(np.float32)
    values = np.exp(rng.normal(size=(rows, N, 1)) * 0.3).astype(np.float32)
    valid = np.ones(rows, bool)
    if padded:
        valid[-5:] = False
        times[-5:], values[-5:] = times[0], values[0]
    return times, values, valid


def jax_params(K, act, scale, seed=1):
    model = JaxModel(input_dim=1, hidden_dim=H, output_dim=1, num_moments=K,
                     activation=act, input_scaling=scale, use_pallas=False)
    return model.init(jax.random.PRNGKey(seed))


def port_model(K, act, scale, params):
    model = NeuralJumpODE(1, H, 1, num_moments=K, activation=act,
                          input_scaling=scale, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        params, num_moments=K, shared_network=False, n_hidden_layers=1))
    return model


@functools.cache
def jax_run(name):
    """The JAX kernel's result for a case: (losses, params, m, v) as port
    state-dict entries (m, v through optax_state_into)."""
    K, method, act, scale, G, padded, split = CASES[name]
    times, values, valid = make_data(G, padded)
    params = jax_params(K, act, scale)
    data = jtk.pack_minibatches(jnp.asarray(times), jnp.asarray(values),
                                jnp.asarray(valid), BS)
    st = jtk.init_train_state(params, num_moments=K, hidden_dim=H)
    kw = dict(n_slots=N, num_moments=K, batch_size=BS, lr=LR,
              weight_decay=WD, variance_method=method, activation=act,
              input_scaling=scale, interpret=True)
    if split is None:
        st, losses = jtk.fused_train_run(st, data, **kw)
    else:
        st, l1 = jtk.fused_train_run(st, data[:split * BS], **kw)
        st, l2 = jtk.fused_train_run(st, data[split * BS:], **kw)
        losses = jnp.concatenate([l1, l2])
    opt = jax_make_adam(LR, WD).init(params)
    p, opt = jtk.optax_state_into(st, G, opt, num_moments=K, hidden_dim=H)
    adam = jtk._find_adam_state(opt)[1]
    bridge = dict(num_moments=K, shared_network=False, n_hidden_layers=1)
    return (np.asarray(losses), state_dict_from_jax(p, **bridge),
            state_dict_from_jax(adam.mu, **bridge),
            state_dict_from_jax(adam.nu, **bridge))


def port_run(name, run=tk.fused_train_run):
    K, method, act, scale, G, padded, split = CASES[name]
    times, values, valid = make_data(G, padded)
    model = port_model(K, act, scale, jax_params(K, act, scale))
    data = tk.pack_minibatches(torch.tensor(times), torch.tensor(values),
                               torch.tensor(valid), BS)
    st = tk.init_train_state(model)
    kw = dict(n_slots=N, num_moments=K, batch_size=BS, lr=LR,
              weight_decay=WD, variance_method=method, activation=act,
              input_scaling=scale)
    if split is None:
        st, losses = run(st, data, **kw)
    else:
        st, l1 = run(st, data[:split * BS], **kw)
        st, l2 = run(st, data[split * BS:], **kw)
        losses = torch.cat([l1, l2])
    return losses, st


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_kernel(name):
    losses, st = port_run(name)
    j_losses, j_p, j_m, j_v = jax_run(name)
    np.testing.assert_allclose(losses.numpy(), j_losses, **LOSS_TOL)
    for ours, ref in ((tk._unpack(st.params, H), j_p),
                      (tk._unpack(st.m, H), j_m), (tk._unpack(st.v, H), j_v)):
        assert set(ours) == set(ref)
        for key in ref:
            np.testing.assert_allclose(ours[key].numpy(), ref[key].numpy(),
                                       err_msg=key, **STATE_TOL)
    G = CASES[name][4]
    np.testing.assert_allclose(st.stat.numpy(), [0.9 ** G, 0.999 ** G],
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["dual-direct", "mean-only",
                                  "selu-identity"])
def test_plain_version_matches_composed_port(name):
    """G steps of the plain version equal G steps of apply_loss + autograd +
    torch.optim.Adam on the same minibatches."""
    K, method, act, scale, G, padded, _ = CASES[name]
    times, values, valid = make_data(G, padded)
    model = port_model(K, act, scale, jax_params(K, act, scale))
    data = tk.pack_minibatches(torch.tensor(times), torch.tensor(values),
                               torch.tensor(valid), BS)
    st, losses = tk.fused_train_run(
        tk.init_train_state(model), data, n_slots=N, num_moments=K,
        batch_size=BS, lr=LR, weight_decay=WD, variance_method=method,
        activation=act, input_scaling=scale)
    opt = torch.optim.Adam(model.parameters(), lr=LR, weight_decay=WD)
    ref = []
    for g in range(G):
        sl = slice(g * BS, (g + 1) * BS)
        opt.zero_grad()
        loss = model.apply_loss(
            times[sl], values[sl], traj_mask=valid[sl],
            ignore_first_continuity=True, moment_weights=[1.0, 10.0],
            variance_method=method)
        loss.backward()
        opt.step()
        ref.append(loss.item())
    np.testing.assert_allclose(losses.numpy(), ref, **LOSS_TOL)
    sd = model.state_dict()
    for key, val in tk.train_state_params(st, H).items():
        np.testing.assert_allclose(val.numpy(), sd[key].numpy(), err_msg=key,
                                   **STATE_TOL)
    # the optimizer state comes out of the kernel state and back
    st2 = tk.kernel_state_from(model, opt.state_dict())
    for a, b in ((st2.m, st.m), (st2.v, st.v), (st2.stat, st.stat)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STATE_TOL)


def test_train_state_round_trips():
    """model + Adam state -> kernel state -> model + Adam state is exact,
    and a fresh optimizer gives zero moments and powers [1, 1]."""
    model = port_model(2, "relu", "identity", jax_params(2, "relu",
                                                         "identity"))
    opt = torch.optim.Adam(model.parameters(), lr=LR, weight_decay=WD)
    fresh = tk.kernel_state_from(model, opt.state_dict())
    assert torch.all(fresh.m == 0) and torch.all(fresh.v == 0)
    assert torch.equal(fresh.stat, torch.ones(2))
    assert fresh.params.shape == (2, tk.n_params_per_net(H))
    sd = model.state_dict()
    for key, val in tk.train_state_params(fresh, H).items():
        assert torch.equal(val, sd[key]), key
    for p in model.parameters():            # give the optimizer some state
        p.grad = torch.randn_like(p)
    opt.step()
    st = tk.kernel_state_from(model, opt.state_dict())
    sd2, osd = tk.optax_state_into(st, 3, opt.state_dict(), model)
    for key, val in model.state_dict().items():
        assert torch.equal(sd2[key], val), key
    for i, s in opt.state_dict()["state"].items():
        assert torch.equal(osd["state"][i]["exp_avg"], s["exp_avg"])
        assert torch.equal(osd["state"][i]["exp_avg_sq"], s["exp_avg_sq"])
        assert float(osd["state"][i]["step"]) == float(s["step"]) + 3
    opt.load_state_dict(osd)                # loadable as it is


def test_pack_minibatches_layout():
    times, values, valid = make_data(1, True)
    data = tk.pack_minibatches(torch.tensor(times), torch.tensor(values),
                               torch.tensor(valid), BS)
    assert data.shape == (BS, 2 * N + 1) and data.dtype == torch.float32
    np.testing.assert_array_equal(data[:, :N].numpy(), values[..., 0])
    np.testing.assert_array_equal(data[:, N:2 * N].numpy(), times)
    np.testing.assert_array_equal(data[:, 2 * N].numpy(), valid)
    with pytest.raises(ValueError, match="multiple"):
        tk.pack_minibatches(torch.tensor(times), torch.tensor(values),
                            torch.tensor(valid), 5)


def _args(K=2):
    model = NeuralJumpODE(1, 8, 1, num_moments=K, device="cpu")
    times, values, valid = make_data(2, False)
    data = tk.pack_minibatches(torch.tensor(times), torch.tensor(values),
                               torch.tensor(valid), BS)
    return tk.init_train_state(model), data


@pytest.mark.parametrize("change,error,match", [
    (dict(batch_size=0), ValueError, "batch_size"),
    (dict(batch_size=6), ValueError, "whole number"),
    (dict(num_moments=3), ValueError, "moments"),
    (dict(activation="sigmoid"), ValueError, "f\\(0\\)=0"),
    (dict(input_scaling="sigmoid"), ValueError, "f\\(0\\)=0"),
    (dict(n_slots=4), ValueError, "data has shape"),
    (dict(variance_method="softplus"), ValueError, "variance_method"),
])
def test_wrapper_refusals(change, error, match):
    state, data = _args()
    kw = dict(n_slots=N, num_moments=2, batch_size=BS)
    kw.update(change)
    with pytest.raises(error, match=match):
        tk.fused_train_run(state, data, **kw)


def test_wrapper_refuses_requires_grad_and_other_devices():
    state, data = _args()
    kw = dict(n_slots=N, num_moments=2, batch_size=BS)
    with pytest.raises(RuntimeError, match="require grad"):
        tk.fused_train_run(state._replace(
            params=state.params.clone().requires_grad_()), data, **kw)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.fused_train_run(state, data.to("meta"), **kw)


def test_cpu_calls_launch_nothing_and_leave_the_input_state():
    state, data = _args()
    before = [x.clone() for x in state]
    tk.LAUNCHES = 0
    out, losses = tk.fused_train_run(state, data, n_slots=N, num_moments=2,
                                     batch_size=BS)
    assert tk.LAUNCHES == 0
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    for a, b in zip(state, before):
        assert torch.equal(a, b)
    assert not torch.equal(out.params, state.params)


@pytest.mark.parametrize("H_,N_,fits", [(32, 10, True), (64, 10, True),
                                        (128, 10, True), (129, 10, False),
                                        (50, 10, True), (12, 5, True),
                                        (128, 60, False), (32, 1, False)])
def test_launch_plan_gates(H_, N_, fits):
    """The port's shape gates: H up to 128 (any H: the wrapper pads it to a
    multiple of 4), N >= 2, one trajectory's working set in the H100's
    shared memory."""
    plan = tk.launch_plan(H_, N_, 128)
    assert (plan is not None) == fits
    if plan is not None:
        assert 1 <= plan.warps <= tk.MAX_WARPS and plan.smem <= tk.SMEM_BYTES
        assert plan.staged == (tk.padded_hidden(H_) <= 64)


def parent_plan_admits(H, N, scale):
    """The one-block kernel's gate (the earlier ``launch_plan``): H a
    multiple of 4 in [4, 128], N >= 2, one warp's slot of 4N + 3(2N-1) +
    4 or 5 (N-1) + 3 rows in the H100's shared memory."""
    S, R = N - 1, 2 * N - 1
    rows = 4 * N + 3 * R + (4 if scale == "identity" else 5) * S + 3
    slot = (rows * H + 8 * N - 4 + 3) & ~3
    return 4 <= H <= 128 and H % 4 == 0 and N >= 2 and 4 * slot <= 232448 - 64


PLAN_SHAPES = [(H, N, scale) for H in (4, 12, 32, 52, 64, 100, 128)
               for N in (2, 10, 25, 40, 60) for scale in ("identity", "tanh")
               if parent_plan_admits(H, N, scale)]
PLAN_BS = (1, 13, 127, 128, 129, 256, 1000, 1024)


@pytest.mark.parametrize("H_,N_,scale", PLAN_SHAPES)
def test_launch_plan_admits_every_shape_it_admitted(H_, N_, scale):
    """Every shape the one-block kernel took is taken, for K in (1, 2) and
    any batch, by a plan that fits: at most MAX_BLOCKS blocks of at most
    MAX_WARPS warps holding the chains of its trajectories in flight, the
    shared memory within the H100's, staged weights beside the slots."""
    for K in (1, 2):
        for BS in PLAN_BS:
            plan = tk.launch_plan(H_, N_, BS, scale, K)
            assert plan is not None, (K, BS)
            assert 1 <= plan.blocks <= min(BS, tk.MAX_BLOCKS)
            assert plan.slots * K * plan.wpt <= plan.warps <= tk.MAX_WARPS
            assert plan.wpt in (1, 2, 4)
            assert plan.smem <= tk.SMEM_BYTES
            slot = 4 * tk._slot_floats(H_, N_, scale, plan.wpt)
            stage = 4 * tk._staged_floats(H_)
            assert plan.smem == ((K * stage if plan.staged else 0)
                                 + (0 if plan.slots_global
                                    else plan.slots * K * slot))
            assert plan.slots_global == (K * slot > tk.SMEM_BYTES)
            assert not (plan.staged and plan.slots_global)


def test_launch_plan_puts_the_default_shape_on_128_blocks():
    """The default recipe (H 32, K 2, N 10, batch 128): a trajectory a
    block on 128 blocks, each network's chain on 4 warps, the weights and
    the slots in shared memory."""
    plan = tk.launch_plan(32, 10, 128, "identity", 2)
    assert (plan.blocks, plan.slots, plan.wpt, plan.warps) == (128, 1, 4, 8)
    assert plan.staged and not plan.slots_global


@pytest.mark.parametrize("bs", [1, 13, 128, 256, 1024])
def test_block_plan_covers_each_minibatch_once_in_order(bs):
    """The blocks' shares are contiguous, in block order, cover every row
    of the minibatch once, differ by at most one row, and each block walks
    its share in chunks of at most ``slots`` trajectories."""
    plan = tk.launch_plan(32, 10, bs)
    rows = tk.block_rows(plan, bs)
    assert len(rows) == plan.blocks
    assert [r for lo, hi in rows for r in range(lo, hi)] == list(range(bs))
    sizes = [hi - lo for lo, hi in rows]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert -(-max(sizes) // plan.slots) * plan.slots < max(sizes) + plan.slots


@pytest.mark.parametrize("H_,N_,bs", [(32, 10, 128), (50, 10, 13),
                                      (128, 25, 128), (32, 10, 1024)])
def test_scratch_does_not_grow_with_steps(H_, N_, bs):
    """The scratch is the weights' padded copy, the slots when they live in
    device memory, each block's partial gradient (K P rounded up to 8) and
    the per-trajectory loss terms: set by the plan and the batch, the same
    for a call of 8 steps and of 1,600."""
    K = 2
    plan = tk.launch_plan(H_, N_, bs, "identity", K)
    Hp = plan.hidden
    slots = (plan.blocks * plan.slots * K
             * tk._slot_floats(Hp, N_, "identity", plan.wpt)
             if plan.slots_global else 0)
    want = (K * tk._staged_floats(Hp) + slots
            + plan.blocks * -(-K * tk.n_params_per_net(Hp) // 8) * 8 + bs)
    assert tk.scratch_floats(plan, K, N_, bs) == want
    import inspect
    assert list(inspect.signature(tk.scratch_floats).parameters) == [
        "plan", "num_moments", "n_slots", "batch_size", "input_scaling"]
    if (H_, N_, bs) == (32, 10, 128):          # the default recipe: 4.5 MB
        assert 4 * want < 5 * 2 ** 20


@pytest.mark.parametrize("K,act,scale", [(2, "relu", "identity"),
                                         (1, "tanh", "tanh"),
                                         (2, "selu", "identity")])
def test_zero_padding_of_hidden_units_is_exact(K, act, scale):
    """H 10 padded to 12 with zero units: the plain version on the padded
    state equals the run on the state itself bitwise, and after Adam with
    weight decay the extra units' params, m and v are still exactly zero
    (f(0) = 0, so their activations and gradients are 0)."""
    H0, Hp = 10, tk.padded_hidden(10)
    assert Hp == 12
    times, values, valid = make_data(3, True)
    model = NeuralJumpODE(1, H0, 1, num_moments=K, activation=act,
                          input_scaling=scale, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    data = tk.pack_minibatches(torch.tensor(times), torch.tensor(values),
                               torch.tensor(valid), BS)
    kw = dict(n_slots=N, num_moments=K, batch_size=BS, lr=LR,
              weight_decay=WD, activation=act, input_scaling=scale)
    # a state with Adam moments, so weight decay and the moments both act
    state, _ = tk.fused_train_run_reference(tk.init_train_state(model),
                                            data, **kw)
    padded = tk.pad_state(state, H0, Hp)
    assert padded.params.shape == (K, tk.n_params_per_net(Hp))
    assert all(torch.equal(tk.unpad_state(padded, Hp, H0)[i], state[i])
               for i in range(4))
    ours, ours_l = tk.fused_train_run_reference(padded, data, **kw)
    ref, ref_l = tk.fused_train_run_reference(state, data, **kw)
    for x in ours[:3]:                  # the extra units stay exactly zero
        assert torch.equal(tk.pad_state(tk.unpad_state(
            tk.TrainState(x, x, x, ours.stat), Hp, H0), H0, Hp).params, x)
    # the zero units add exact zeros to every sum: the runs agree bitwise
    assert torch.equal(ours_l, ref_l)
    for a, b in zip(tk.unpad_state(ours, Hp, H0), ref):
        assert torch.equal(a, b)


def test_trainer_takes_the_kernel_at_hidden_50():
    """Hidden 50 with separate networks (not a multiple of 4) passes the
    Trainer's gate and trains through the kernel's wrapper (its plain
    version here), as the JAX Trainer does."""
    from njode_tpu_torch.utils import Trainer, make_adam
    model = NeuralJumpODE(1, 50, 1, num_moments=2, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    tr = Trainer(model, make_adam(model.parameters(), LR, WD),
                 ignore_first_continuity=True, moment_weights=[1.0, 10.0],
                 use_train_kernel=True)
    tr._train_kernel_check(128, n_slots=10)
    assert tk.kernel_fits(50, 10)


@functools.cache
def default_shape_run():
    """The default recipe's shape: H 32, K 2, N 10, batch 128, 8 steps, the
    last minibatch 104 rows valid; the JAX kernel (interpret) and the
    port's plain version on the same numpy inputs."""
    Hd, Nd, Bd, G = 32, 10, 128, 8
    rng = np.random.default_rng(5)
    rows = G * Bd
    idx = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, 101), Nd - 1, replace=False)])
        for _ in range(rows)]), axis=1)
    times = (idx * 0.01).astype(np.float32)
    values = np.exp(rng.normal(size=(rows, Nd, 1)) * 0.3).astype(np.float32)
    valid = np.ones(rows, bool)
    valid[-(Bd - 104):] = False
    times[~valid], values[~valid] = times[0], values[0]
    model = JaxModel(input_dim=1, hidden_dim=Hd, output_dim=1, num_moments=2,
                     use_pallas=False)
    params = model.init(jax.random.PRNGKey(7))
    kw = dict(n_slots=Nd, num_moments=2, batch_size=Bd, lr=LR,
              weight_decay=WD)
    jdata = jtk.pack_minibatches(jnp.asarray(times), jnp.asarray(values),
                                 jnp.asarray(valid), Bd)
    jst, jl = jtk.fused_train_run(
        jtk.init_train_state(params, num_moments=2, hidden_dim=Hd), jdata,
        interpret=True, **kw)
    opt = jax_make_adam(LR, WD).init(params)
    p, opt = jtk.optax_state_into(jst, G, opt, num_moments=2, hidden_dim=Hd)
    adam = jtk._find_adam_state(opt)[1]
    bridge = dict(num_moments=2, shared_network=False, n_hidden_layers=1)
    ours_model = NeuralJumpODE(1, Hd, 1, num_moments=2, device="cpu")
    ours_model.load_state_dict(state_dict_from_jax(params, **bridge))
    data = tk.pack_minibatches(torch.tensor(times), torch.tensor(values),
                               torch.tensor(valid), Bd)
    st, losses = tk.fused_train_run(tk.init_train_state(ours_model), data,
                                    **kw)
    return (Hd, (np.asarray(jl), state_dict_from_jax(p, **bridge),
                 state_dict_from_jax(adam.mu, **bridge),
                 state_dict_from_jax(adam.nu, **bridge)), (losses, st))


def test_plain_version_matches_jax_kernel_at_the_default_shape():
    """The plain version (which the kernel is held against on the card)
    against the JAX kernel at the default recipe's own shape, at the
    file's tolerances."""
    Hd, (j_losses, j_p, j_m, j_v), (losses, st) = default_shape_run()
    np.testing.assert_allclose(losses.numpy(), j_losses, **LOSS_TOL)
    for ours, ref in ((tk._unpack(st.params, Hd), j_p),
                      (tk._unpack(st.m, Hd), j_m),
                      (tk._unpack(st.v, Hd), j_v)):
        assert set(ours) == set(ref)
        for key in ref:
            np.testing.assert_allclose(ours[key].numpy(), ref[key].numpy(),
                                       err_msg=key, **STATE_TOL)


def test_availability_is_the_jax_scope():
    for args in [(False, 1, 1, 1, "relu", 0.0, "identity", None),
                 (True, 1, 1, 1, "relu", 0.0, "identity", None),
                 (False, 2, 2, 1, "relu", 0.0, "identity", None),
                 (False, 1, 1, 2, "relu", 0.0, "identity", None),
                 (False, 1, 1, 1, "relu", 0.1, "identity", None),
                 (False, 1, 1, 1, "relu", 0.0, "identity", 0.01),
                 (False, 1, 1, 1, "sigmoid", 0.0, "identity", None),
                 (False, 1, 1, 1, "tanh", 0.0, "sigmoid", None)]:
        assert tk.train_kernel_available(*args) == \
            jtk.train_kernel_available(*args), args
