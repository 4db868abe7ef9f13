"""The walk-train kernel's plain version
(njode_tpu_torch/ops/walk_train.py ``fused_walk_train_run_reference``) held
against the JAX package's ``fused_walk_train_run`` in Pallas interpret mode
on the CPU, as tests/test_walk_train.py runs it (H = 12, N = 5, batch 16,
dt 0.05 on a 20-step grid, so M = 20).  On the CPU the wrapper runs the
plain version; the CUDA kernel (``ops/csrc/walk_train.cu``) is held against
it on the card by ``chip_smoke.py``.

Data come from numpy with a seed (obs-only-style rows on the grid), weights
from JAX's init through the weight bridge.  Tolerance rtol 2e-4 / atol 1e-5
on per-step losses, parameters and Adam m and v, the JAX package's own for
its kernel against optax (tests/test_walk_train.py:94): f32 sums in other
orders through 20 compounded cells and Adam's normalised step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.ops import walk_train as jwt
from njode_tpu.ops.train_kernel import pack_minibatches as jax_pack
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.ops import pack_minibatches
from njode_tpu_torch.ops import walk_train as wt
from njode_tpu_torch.utils import make_adam, state_dict_from_jax

H, N, BS, DT, M = 12, 5, 16, 0.05, 20
TOL = dict(rtol=2e-4, atol=1e-5)
LR, WD = 1e-3, 5e-4

# K, variance_method, solver, activation, scaling, G, padded last minibatch
CASES = {
    "euler-direct": (2, "direct", "euler", "relu", "identity", 3, True),
    "euler-second-moment": (2, "second_moment", "euler", "tanh", "tanh", 3,
                            False),
    "mean-only": (1, "direct", "euler", "relu", "identity", 3, False),
    "heun": (2, "direct", "heun", "relu", "identity", 3, False),
    "rk4": (2, "second_moment", "rk4", "elu", "identity", 3, True),
}


def make_data(G, padded, seed=0):
    """G minibatches of N grid times (slot 0 at t = 0, the last slot of
    every fourth row at t = T) and lognormal values; with ``padded`` the
    last 5 rows are padding that repeats row 0, as the Trainer pads."""
    rng = np.random.default_rng(seed)
    rows = G * BS
    cells = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, M), N - 1, replace=False)])
        for _ in range(rows)]), axis=1)
    cells[::4, -1] = M
    times = (cells * DT).astype(np.float32)
    values = np.exp(rng.normal(size=(rows, N, 1)) * 0.3).astype(np.float32)
    valid = np.ones(rows, bool)
    if padded:
        valid[-5:] = False
        times[-5:], values[-5:] = times[0], values[0]
    return times, values, valid


def jax_params(K, act, scale, solver, seed=1):
    return JaxModel(input_dim=1, hidden_dim=H, output_dim=1, num_moments=K,
                    activation=act, input_scaling=scale, shared_network=True,
                    dt_ode_step=DT, t_max=1.0, ode_solver=solver,
                    use_pallas=False).init(jax.random.PRNGKey(seed))


def port_model(K, act="relu", scale="identity", solver="euler", params=None):
    model = NeuralJumpODE(1, H, 1, num_moments=K, activation=act,
                          input_scaling=scale, shared_network=True,
                          dt_ode_step=DT, t_max=1.0, ode_solver=solver,
                          grid_walk=True, device="cpu")
    if params is not None:
        model.load_state_dict(state_dict_from_jax(
            params, num_moments=K, shared_network=True, n_hidden_layers=1))
    return model


def kwargs(K, method="direct", solver="euler", act="relu", scale="identity"):
    return dict(n_slots=N, num_moments=K, batch_size=BS, hidden_dim=H,
                dt_ode_step=DT, max_substeps=M, lr=LR, weight_decay=WD,
                moment_weights=[1.0, 10.0][:K], variance_method=method,
                activation=act, input_scaling=scale, ode_solver=solver)


@functools.cache
def jax_run(name):
    K, method, solver, act, scale, G, padded = CASES[name]
    times, values, valid = make_data(G, padded)
    params = jax_params(K, act, scale, solver)
    data = jax_pack(jnp.asarray(times), jnp.asarray(values),
                    jnp.asarray(valid), BS)
    st = jwt.init_walk_state(params, num_moments=K, hidden_dim=H)
    st, losses = jwt.fused_walk_train_run(
        st, data, interpret=True, **kwargs(K, method, solver, act, scale))
    opt = jax_make_adam(LR, WD).init(params)
    p, opt = jwt.optax_state_into_walk(st, G, opt, num_moments=K,
                                       hidden_dim=H)
    adam = next(s for s in opt if hasattr(s, "mu"))
    bridge = dict(num_moments=K, shared_network=True, n_hidden_layers=1)
    return (np.asarray(losses), state_dict_from_jax(p, **bridge),
            state_dict_from_jax(adam.mu, **bridge),
            state_dict_from_jax(adam.nu, **bridge))


def port_state(name):
    K, method, solver, act, scale, G, padded = CASES[name]
    times, values, valid = make_data(G, padded)
    model = port_model(K, act, scale, solver,
                       jax_params(K, act, scale, solver))
    data = pack_minibatches(torch.tensor(times), torch.tensor(values),
                            torch.tensor(valid), BS)
    return model, data, kwargs(K, method, solver, act, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_kernel(name):
    model, data, kw = port_state(name)
    wt.LAUNCHES = 0
    st, losses = wt.fused_walk_train_run(wt.init_walk_state(model), data,
                                         **kw)
    assert wt.LAUNCHES == 0
    j_losses, j_p, j_m, j_v = jax_run(name)
    np.testing.assert_allclose(losses.numpy(), j_losses, **TOL)
    K = kw["num_moments"]
    for ours, ref in ((wt._unpack(st.params, H, K), j_p),
                      (wt._unpack(st.m, H, K), j_m),
                      (wt._unpack(st.v, H, K), j_v)):
        assert set(ours) == set(ref)
        for key in ref:
            np.testing.assert_allclose(ours[key].numpy(), ref[key].numpy(),
                                       err_msg=key, **TOL)
    G = CASES[name][5]
    np.testing.assert_allclose(st.stat.numpy(), [0.9 ** G, 0.999 ** G],
                               rtol=1e-6)


def test_state_round_trip_and_resume():
    """model + Adam state -> train state -> back is exact; two calls over
    halves of the data equal one call over all of it."""
    model, data, kw = port_state("euler-direct")
    opt = make_adam(model.parameters(), LR, WD)
    fresh = wt.walk_state_from(model, opt.state_dict())
    assert torch.all(fresh.m == 0) and torch.equal(fresh.stat, torch.ones(2))
    assert fresh.params.shape == (wt.n_params(H, 2),)
    for key, val in wt.walk_train_params(fresh, H, 2).items():
        assert torch.equal(val, model.state_dict()[key]), key
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    st = wt.walk_state_from(model, opt.state_dict())
    sd, osd = wt.optax_state_into_walk(st, 3, opt.state_dict(), model)
    for key, val in model.state_dict().items():
        assert torch.equal(sd[key], val), key
    for i, s in opt.state_dict()["state"].items():
        assert torch.equal(osd["state"][i]["exp_avg_sq"], s["exp_avg_sq"])
        assert float(osd["state"][i]["step"]) == float(s["step"]) + 3
    opt.load_state_dict(osd)

    one, l_one = wt.fused_walk_train_run(st, data, **kw)
    half, l1 = wt.fused_walk_train_run(st, data[:BS], **kw)
    two, l2 = wt.fused_walk_train_run(half, data[BS:], **kw)
    np.testing.assert_allclose(torch.cat([l1, l2]).numpy(), l_one.numpy(),
                               rtol=1e-6)
    for a, b in zip(one, two):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-8)


def test_checkpoint_interop_with_the_composed_path():
    """G composed steps (apply_loss + autograd + torch.optim.Adam on the
    grid walk), then G plain-version steps from the converted state, equal
    2G composed steps; the train state then loads back into the model and
    optimizer."""
    G = 2
    times, values, valid = make_data(2 * G, False, seed=7)
    data = pack_minibatches(torch.tensor(times), torch.tensor(values),
                            torch.tensor(valid), BS)
    params = jax_params(2, "relu", "identity", "euler", seed=4)

    def composed(model, opt, g0, g1):
        for g in range(g0, g1):
            sl = slice(g * BS, (g + 1) * BS)
            opt.zero_grad()
            model.apply_loss(times[sl], values[sl],
                             ignore_first_continuity=True,
                             moment_weights=[1.0, 10.0]).backward()
            opt.step()

    ref = port_model(2, params=params)
    ref_opt = make_adam(ref.parameters(), LR, WD)
    composed(ref, ref_opt, 0, 2 * G)

    mid = port_model(2, params=params)
    opt = make_adam(mid.parameters(), LR, WD)
    composed(mid, opt, 0, G)
    st = wt.walk_state_from(mid, opt.state_dict())
    st, _ = wt.fused_walk_train_run(st, data[G * BS:], **kwargs(2))
    sd, osd = wt.optax_state_into_walk(st, G, opt.state_dict(), mid)
    mid.load_state_dict(sd)
    opt.load_state_dict(osd)
    for name, val in ref.state_dict().items():
        np.testing.assert_allclose(mid.state_dict()[name].numpy(),
                                   val.numpy(), err_msg=name, **TOL)
    assert float(opt.state_dict()["state"][0]["step"]) == 2 * G


# the shape gate: (hidden, batch, slots, max_substeps, solver, admitted)
GATE_SHAPES = [
    (50, 256, 10, 100, "euler", True),     # the production row
    (50, 120, 10, 1000, "euler", True),    # any batch, fine dt
    (70, 16, 5, 20, "rk4", True),
    (128, 1024, 10, 100, "rk4", True),     # the widest: a chunked buffer
    (1, 1, 2, 1, "heun", True),
    (129, 256, 10, 100, "euler", False),
    (50, 2048, 10, 100, "euler", False),
    (50, 256, 1, 100, "euler", False),
    (50, 256, 10, 0, "euler", False),
]


@pytest.mark.parametrize("case", ["scope", "refusals", *GATE_SHAPES])
def test_gates_and_refusals(case):
    if case == "scope":
        assert wt.walk_train_available(True, 1, 1, 1, "relu", 0.0,
                                       "identity", 0.01)
        for args in [(False, 1, 1, 1, "relu", 0.0, "identity", 0.01),
                     (True, 1, 1, 1, "relu", 0.0, "identity", None),
                     (True, 2, 1, 1, "relu", 0.0, "identity", 0.01),
                     (True, 1, 1, 2, "relu", 0.0, "identity", 0.01),
                     (True, 1, 1, 1, "relu", 0.1, "identity", 0.01)]:
            assert wt.walk_train_available(*args) == \
                jwt.walk_train_available(*args) is False, args
        assert not wt.walk_train_available(True, 1, 1, 1, "relu", 0.0,
                                           "identity", 0.01, "midpoint")
        plan = wt.launch_plan(50, 256, 10, "euler", 100)
        # the production plan: 128 blocks of 2 trajectories, 4 warps each,
        # O1 in its own plane, every cell of the walk in one buffer pass
        assert (plan.warps, plan.wpt, plan.blocks) == (8, 4, 128)
        assert plan.four and plan.chunk == 100
        assert plan.smem_bytes <= wt.SMEM_BYTES
    elif case == "refusals":
        model, data, kw = port_state("euler-direct")
        st = wt.init_walk_state(model)
        with pytest.raises(ValueError, match="mxu_dtype"):
            wt.fused_walk_train_run(st, data, **kw, mxu_dtype="float16")
        with pytest.raises(ValueError, match="whole number"):
            wt.fused_walk_train_run(st, data[:BS - 1], **kw)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            wt.fused_walk_train_run(st, data.to("meta"), **kw)
        with pytest.raises(RuntimeError, match="require grad"):
            wt.fused_walk_train_run(st._replace(
                params=st.params.clone().requires_grad_()), data, **kw)
    else:
        *shape, admitted = case
        assert wt.walk_train_shapes_ok(*shape) is admitted


def parent_plan(H, BS, N, solver):
    """The launch plan's shape rule before the kernel's redesign (one
    trajectory a warp, 4-8 trajectory warps a block and as many helpers,
    per-cell sums in shared memory): (warps, staged, bytes) or None."""
    if not (1 <= H <= 128 and 1 <= BS <= 1024 and N >= 2
            and solver in wt._TABLEAU):
        return None
    n_st = len(wt._TABLEAU[solver][0])
    warps = min(8, max(4, -(-BS // 128)))
    for staged in (True, False):
        b = 4 * ((4 * H * (H | 1) if staged else 0) + 2 * H * H + 4 * H
                 + (3 + 6 * n_st) * warps * H + (3 + n_st) * warps
                 + warps * N)
        if b <= 232448 - 128:
            return warps, staged, b
    return None


PLAN_H = (1, 2, 12, 31, 32, 33, 50, 63, 64, 65, 100, 127, 128)
PLAN_BS = (1, 2, 31, 64, 100, 128, 129, 255, 256, 257, 300, 384, 512, 513,
           640, 768, 1000, 1023, 1024)
PLAN_N = (2, 10, 33, 100, 1000)


@pytest.mark.parametrize("solver", ["euler", "heun", "rk4"])
def test_launch_plan_admits_every_shape_it_admitted(solver):
    """At every shape the earlier plan admitted (and more: it no longer
    bounds N) the plan fits: shared memory within the H100's 227 KB, the
    step buffer within its cap, at most 128 blocks of at most 8 warps that
    hold the whole minibatch, a trajectory's warps dividing the block's."""
    for H in PLAN_H:
        for BS in PLAN_BS:
            for N in PLAN_N:
                plan = wt.launch_plan(H, BS, N, solver, 100)
                if parent_plan(H, BS, N, solver) is not None:
                    assert plan is not None, (H, BS, N)
                assert plan is not None, (H, BS, N)
                assert plan.smem_bytes <= 232448 - 128
                assert plan.smem_bytes == 4 * wt._smem_floats(
                    H, plan.warps, plan.four)
                assert plan.buffer_bytes <= wt.STEP_BUFFER_BYTES
                assert 1 <= plan.chunk <= 100
                assert plan.warps <= wt.MAX_WARPS
                assert plan.warps % plan.wpt == 0
                assert plan.blocks <= wt.TARGET_BLOCKS
                assert plan.blocks * (plan.warps // plan.wpt) >= BS


@pytest.mark.parametrize("shape", [
    (0, 256, 10, "euler"), (129, 256, 10, "euler"), (50, 0, 10, "euler"),
    (50, 1025, 10, "euler"), (50, 256, 1, "euler"), (50, 256, 10, "midpoint"),
])
def test_launch_plan_refuses_what_it_refused(shape):
    assert parent_plan(*shape) is None
    assert wt.launch_plan(*shape) is None


def test_launch_plan_chunks_the_widest_buffer():
    """At the widest shape the gate admits (H 128, batch 1,024, rk4) a cell
    of the step buffer holds 8.5 MB, so a pass holds 2 cells; the
    production buffer (21 MB) holds all 100."""
    wide = wt.launch_plan(128, 1024, 10, "rk4", 100)
    assert wide.chunk == 2 and not wide.four and wide.wpt == 1
    assert wide.buffer_bytes == 2 * 4 * 1024 * 4 * wt._record_floats(128)
    prod = wt.launch_plan(50, 256, 10, "euler", 100)
    assert prod.buffer_bytes == 100 * 4 * 256 * wt._record_floats(50)
