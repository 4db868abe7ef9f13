"""Row 5's data flow (csrc/gap_train.cu's backward, rows 4-5) as a plain
version, held against the reverse loop's plain version and the JAX package.

``gap_bwd_records_reference`` (njode_tpu_torch/ops/gap_scan.py) does what
the kernel does, in its order: each row's substeps counted by the loop's
float sequence, the rows sorted longest first (stable), segments from the
top down with the records s(h), g_pre, act(pre) and g_dh of every substep
of a segment (zeros where a row takes none), the weight sums by chunks of
sorted rows added segment by segment, the chunks in order.  The kernel is
held against it on the card (chip_smoke.py's phase 21); here it is held
against ``gap_train_backward_reference`` (the reverse loop with its sums
inside) and, through ``GapScan``'s CPU backward, against the JAX kernel
pair's VJP (``integrate_gap_fused``, Pallas in interpret mode).

Tolerances: against the reverse loop, rtol 1e-5 / atol 1e-6 (the weight
sums' other order over up to 2,304 substep records in f32); against JAX,
the gradients at rtol 1e-4 / atol 1e-5 as tests/test_torch_gap_train.py
holds the reverse loop.  Counts, t_L and the order are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu.ops import integrate_gap_fused as jax_integrate
from njode_tpu_torch.ops import gap_scan

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PAIRS = (("relu", "identity"), ("tanh", "tanh"), ("selu", "sigmoid"))


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


def port_grads(c, act, scale):
    """The same through the port's integrate_gap_fused (GapScan with its
    CPU plain versions), weights in torch's orientation."""
    t = torch.from_numpy
    h, x = t(c["h"]).requires_grad_(), t(c["x"]).requires_grad_()
    raw = [t(np.swapaxes(c["w1"], 1, 2).copy()).requires_grad_(),
           t(c["b1"]).requires_grad_(),
           t(np.swapaxes(c["w2"], 1, 2).copy()).requires_grad_(),
           t(c["b2"]).requires_grad_()]
    out, _ = gap_scan.integrate_gap_fused(
        h, x, t(c["t0"]), t(c["t1"]), gap_scan.split_weights(raw), c["dt"],
        c["n_sub"], act, scale)
    g = torch.autograd.grad(out, [h, x, *raw], t(c["ct"]))
    return [out.detach().numpy(), g[0].numpy(), g[1].numpy(),
            g[2].transpose(1, 2).numpy(), g[3].numpy(),
            g[4].transpose(1, 2).numpy(), g[5].numpy()]


def long_among_short(seed, K, R, d_h, n_sub, dt=0.01, n_long=2):
    """test_torch_gap_train's gap kinds, short gaps (up to 12 substeps), and
    ``n_long`` rows whose gap outlasts the budget, among them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t0 = rng.uniform(0.0, 0.2, R).astype(f32)
    t1 = t0 + rng.uniform(0.0, dt * 12, R).astype(f32)
    t1[0] = t0[0]
    t1[1] = t0[1] + f32(0.4 * dt)
    for r in rng.choice(np.arange(2, R), n_long, replace=False):
        t1[r] = t0[r] + f32(dt * (n_sub + 1))
    d_in = d_h + 3
    return {"h": (rng.normal(size=(K, R, d_h)) * 0.5).astype(f32),
            "x": rng.normal(size=(R, 1)).astype(f32), "t0": t0, "t1": t1,
            "w1": (rng.normal(size=(K, d_in, d_h)) * 0.3).astype(f32),
            "b1": (rng.normal(size=(K, d_h)) * 0.1).astype(f32),
            "w2": (rng.normal(size=(K, d_h, d_h)) * 0.3).astype(f32),
            "b2": (rng.normal(size=(K, d_h)) * 0.1).astype(f32),
            "ct": rng.normal(size=(K, R, d_h)).astype(f32),
            "dt": dt, "n_sub": n_sub}


def pair_args(c, act, scale):
    """The training pair's arguments (GapScan's) from a case, and the plain
    forward's residuals at the stride of n_sub."""
    t = torch.from_numpy
    raw = [t(np.swapaxes(c["w1"], 1, 2).copy()), t(c["b1"]),
           t(np.swapaxes(c["w2"], 1, 2).copy()), t(c["b2"])]
    args = gap_scan.substep_inputs(t(c["h"]), t(c["x"]), t(c["t0"]),
                                   t(c["t1"]), gap_scan.split_weights(raw),
                                   c["dt"])
    stride = gap_scan.residual_stride(c["n_sub"])
    fwd = gap_scan.gap_train_forward_reference(*args, c["dt"], c["n_sub"],
                                               stride, act, scale)
    bargs = (t(c["ct"]), args[1], args[3], *args[4:], fwd[2], fwd[3],
             c["dt"], c["n_sub"], stride, act, scale)
    return args, fwd, bargs


@pytest.mark.parametrize("n_sub", [17, 100])
def test_counts_are_the_forwards_float_sequence(n_sub):
    """The counts' t sequence ends bitwise at the forward's t_L, and the
    count is the number of dt steps between t_last and t_L."""
    c = long_among_short(n_sub, 1, 60, 5, n_sub)
    args, fwd, _ = pair_args(c, "relu", "identity")
    counts, t_l = gap_scan.gap_substep_counts(args[2], args[3], c["dt"],
                                              n_sub)
    assert torch.equal(t_l, fwd[1])
    assert int(counts.max()) == n_sub and int(counts.min()) == 0
    assert torch.equal(counts > 0, fwd[1] > args[2])


@pytest.mark.parametrize("n_sub,stride", [(17, 8), (100, 8), (2000, 8),
                                          (2000, 16)])
def test_order_is_longest_first_and_stable(n_sub, stride):
    """The sort key descends along the order and rows of one key keep their
    row order; past GAP_BWD_BINS - 1 substeps the key is the segment
    count; every segment's active rows are a prefix of the order."""
    rng = np.random.default_rng(n_sub)
    counts = torch.from_numpy(rng.integers(0, n_sub + 1, 500))
    counts[rng.integers(0, 500, 100)] = 3          # many ties
    seg = gap_scan.bwd_segment(stride)
    order = gap_scan.gap_bwd_order(counts, n_sub, seg)
    key = counts if n_sub + 1 <= gap_scan.GAP_BWD_BINS else -(-counts // seg)
    ks = key[order]
    assert bool((ks[:-1] >= ks[1:]).all())
    same = ks[:-1] == ks[1:]
    assert bool((order[:-1][same] < order[1:][same]).all())
    assert sorted(order.tolist()) == list(range(500))
    cs = counts[order]
    for s in range(-(-n_sub // seg)):
        active = (cs > s * seg).int()
        na = int(active.sum())
        assert bool((active[:na] == 1).all()) and bool((active[na:] == 0).all())


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("n_sub", [10, 17, 100])
def test_records_flow_matches_the_reverse_loop(n_sub, K):
    """All six outputs of the records flow (rows 4-5) against the reverse
    loop's plain version at n_sub 10 (stride 1), 17 and 100 (stride 8), a
    long gap among short ones, chunks of 32 and of 7 sorted rows."""
    act, scale = PAIRS[(n_sub + K) % 3]
    c = long_among_short(3 * n_sub + K, K, 70, 6, n_sub)
    _, _, bargs = pair_args(c, act, scale)
    ref = gap_scan.gap_train_backward_reference(*bargs)
    for chunk in (None, 7):
        ours = gap_scan.gap_bwd_records_reference(*bargs, chunk_rows=chunk)
        for name, a, b in zip(("gh0", "gpre_sum", "acc_t", "gdh_sum", "dW1h",
                               "dW2"), ours, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("K", [1, 2])
def test_records_flow_keyed_by_segment_count(K):
    """Past GAP_BWD_BINS - 1 substeps (n_sub 1,100, where the sort keys
    rows by segment count): the records flow against the reverse loop,
    rows of 541-556 substeps (segment keys 68-70 about the long threshold
    of 69, several counts to a key) and of 100-300 among short ones, and
    one gap of the whole budget; rtol 1e-5 / atol 1e-6."""
    n_sub = 1100
    c = long_among_short(40 + K, K, 48, 4, n_sub, n_long=1)
    c["t1"][2:18] = c["t0"][2:18] + np.float32(0.01) * (
        np.arange(541, 557) + 0.5).astype(np.float32)
    c["t1"][20:24] = c["t0"][20:24] + np.float32(0.01) * np.float32(
        [100.5, 180.5, 240.5, 300.5])
    assert gap_scan.gap_bwd_plan(4, 48, n_sub, 8, K).key_seg
    _, _, bargs = pair_args(c, "tanh", "tanh")
    ref = gap_scan.gap_train_backward_reference(*bargs)
    ours = gap_scan.gap_bwd_records_reference(*bargs)
    for name, a, b in zip(("gh0", "gpre_sum", "acc_t", "gdh_sum", "dW1h",
                           "dW2"), ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_records_flow_adds_zero_for_rows_without_substeps():
    """Rows that take no substep keep the incoming cotangent and zero row
    sums, and a call with no substep at all has zero weight sums."""
    c = long_among_short(5, 2, 30, 4, 17, n_long=0)
    c["t1"] = c["t0"].copy()
    _, _, bargs = pair_args(c, "tanh", "tanh")
    gh0, gp, at, gd, dw1, dw2 = gap_scan.gap_bwd_records_reference(*bargs)
    assert torch.equal(gh0, bargs[0])
    for x in (gp, at, gd, dw1, dw2):
        assert not bool(x.any())


@pytest.mark.parametrize("K", [1, 2], ids=["shared", "separate"])
@pytest.mark.parametrize("n_sub", [17, 100])
def test_records_flow_matches_jax(monkeypatch, n_sub, K):
    """GapScan with the records flow as its CPU backward: h(t_target) and
    the cotangents of h, x and the ODEFunc weights against the JAX kernel
    pair (interpret mode), with long gaps among short ones."""
    act, scale = PAIRS[(n_sub + 2 * K) % 3]
    c = long_among_short(n_sub + K, K, 13, 6, n_sub, n_long=3)
    monkeypatch.setattr(gap_scan, "gap_train_backward_reference",
                        gap_scan.gap_bwd_records_reference)
    ours, ref = port_grads(c, act, scale), jax_grads(c, act, scale)
    np.testing.assert_allclose(ours[0], ref[0], **TOL)
    for name, a, b in zip(("h", "x", "W1", "b1", "W2", "b2"), ours[1:],
                          ref[1:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
