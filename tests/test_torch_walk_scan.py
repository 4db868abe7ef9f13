"""The grid walk's plain version (njode_tpu_torch/ops/walk_scan.py
``walk_gaps_reference``) held against the JAX package's ``walk_gaps_fused``
in Pallas interpret mode on the CPU: the pre-jump states, and through
``torch.autograd`` against ``jax.grad`` the cotangents of the jump states
and of the ODEFunc weights.  On the CPU the wrapper runs the plain version;
the CUDA kernels (``ops/csrc/walk_scan.cu``) are held against it on the card
by ``chip_smoke.py``.

The kernels' own data flow has explicit plain versions too: the forward
with its residuals and the backward that writes the records (hid, gp, gdh)
at every cell and then sums the weight cotangents as A^T G over the record
rows in the kernel's chunk order (``walk_forward_reference``,
``walk_backward_reference``); they are held against the JAX package's VJP
and against autograd through ``walk_gaps_reference``.

Inputs come from numpy with a seed: times on the grid {g * 0.05}, M = 20
cells, a ragged mask, and a slot at t = T (cell M, which reads the final
carry).  Tolerance rtol 1e-5 / atol 1e-6: the TPU kernel sums the t, x and
bias features inside its 128-lane product, in another order than the plain
version, over 20 compounded cells.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu.ops.walk_scan import walk_gaps_fused as jax_walk
from njode_tpu_torch.ops import walk_scan

DT, M, N, B = 0.05, 20, 5, 6
TOL = dict(rtol=1e-5, atol=1e-6)


def make_case(K, d, seed=0):
    """Grid times (row 1 ends at t = T, rows 2 and 3 ragged), values, jump
    states, ODEFunc weights in torch orientation, and a cotangent."""
    rng = np.random.default_rng(seed)
    cells = np.sort(np.stack([np.concatenate(
        [[0], rng.choice(np.arange(1, M), N - 1, replace=False)])
        for _ in range(B)]), axis=1)
    cells[1, -1] = M
    mask = np.ones((B, N), bool)
    mask[2, 3:] = False
    mask[3, 4:] = False
    for b in (2, 3):                     # padding repeats the last valid slot
        n = mask[b].sum()
        cells[b, n:] = cells[b, n - 1]
    times = (cells * DT).astype(np.float32)
    x = np.exp(rng.normal(size=(B, N, 1)) * 0.3).astype(np.float32)
    hj = (rng.normal(size=(K, B, N, d)) * 0.5).astype(np.float32)
    u = lambda *s: (rng.uniform(-1, 1, s) / np.sqrt(s[-1])).astype(np.float32)
    weights = [u(K, d, d + 3), u(K, d), u(K, d, d), u(K, d)]
    ct = rng.normal(size=(K, B * (N - 1), d)).astype(np.float32)
    return times, x, mask, hj, weights, ct


def jax_side(case, act, scale):
    times, x, mask, hj, (w1, b1, w2, b2), ct = case
    g = jnp.asarray(np.round(times / DT).astype(np.int32))
    sc = {"identity": lambda v: v, "tanh": jnp.tanh}[scale]

    def f(hj_, w1_, b1_, w2_, b2_):
        layers = [{"w": jnp.swapaxes(w1_, 1, 2), "b": b1_},
                  {"w": jnp.swapaxes(w2_, 1, 2), "b": b2_}]
        return jax_walk(layers, hj_, sc(jnp.asarray(x)), jnp.asarray(times),
                        jnp.asarray(mask), g, DT, M, act, scale,
                        interpret=True)

    args = [jnp.asarray(a) for a in (hj, w1, b1, w2, b2)]
    out, vjp = jax.vjp(f, *args)
    return np.asarray(out), [np.asarray(a) for a in vjp(jnp.asarray(ct))]


def port_side(case, act, scale):
    times, x, mask, hj, weights, ct = case
    hj_t = torch.tensor(hj, requires_grad=True)
    w_t = [torch.tensor(w, requires_grad=True) for w in weights]
    tt = torch.tensor(times)
    g = torch.round(tt / DT).to(torch.int64)
    sc = {"identity": lambda v: v, "tanh": torch.tanh}[scale]
    walk_scan.LAUNCHES_FWD = walk_scan.LAUNCHES_BWD = 0
    out = walk_scan.walk_gaps_fused(hj_t, sc(torch.tensor(x)), tt,
                                    torch.tensor(mask), g, w_t, DT, M, act,
                                    scale)
    grads = torch.autograd.grad(out, [hj_t, *w_t], torch.tensor(ct))
    assert walk_scan.LAUNCHES_FWD == walk_scan.LAUNCHES_BWD == 0
    return out.detach().numpy(), [g_.numpy() for g_ in grads]


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("act,scale,d", [("relu", "identity", 12),
                                         ("tanh", "tanh", 12),
                                         ("selu", "identity", 70)])
def test_walk_matches_jax_kernel(K, act, scale, d):
    case = make_case(K, d, seed=K * d)
    ref, ref_grads = jax_side(case, act, scale)
    out, grads = port_side(case, act, scale)
    np.testing.assert_allclose(out, ref, **TOL)
    for name, a, b in zip(("h_jump", "W1", "b1", "W2", "b2"), grads,
                          ref_grads):
        np.testing.assert_allclose(a, b, err_msg=name, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))
    # padded slots get no jump cotangent; the endpoint slot reads the final
    # carry and never resets
    hj_grad = grads[0]
    assert np.all(hj_grad[:, 2, 3:] == 0) and np.all(hj_grad[:, 3, 4:] == 0)
    assert np.all(hj_grad[:, 1, -1] == 0)


def records_side(case, act, scale, chunk_rows=None):
    """The plain forward with residuals and the plain backward of the
    kernels' data flow (records, then chunked sums)."""
    times, x, mask, hj, weights, ct = case
    K, _, _, d = hj.shape
    tt = torch.tensor(times)
    g = torch.round(tt / DT).to(torch.int64)
    sc = {"identity": lambda v: v, "tanh": torch.tanh}[scale]
    reset, read = walk_scan.slot_cells(torch.tensor(mask), g, M)
    w1_io, cvec, w2_io, b2 = walk_scan.split_walk_weights(
        [torch.tensor(w) for w in weights], DT)
    h_minus, res_h, res_t, res_x = walk_scan.walk_forward_reference(
        torch.tensor(hj), sc(torch.tensor(x))[..., 0], tt, reset, read,
        w1_io, cvec, w2_io, b2, DT, M, act, scale)
    ct_hj, grads = walk_scan.walk_backward_reference(
        torch.tensor(ct).reshape(K, B, N - 1, d), res_h, res_t, res_x, reset,
        read, w1_io, cvec, w2_io, DT, act, scale, chunk_rows)
    assert res_h.shape == (K, M, B, d) and res_t.shape == res_x.shape == (M, B)
    return (h_minus.reshape(K, B * (N - 1), d).numpy(),
            [g_.numpy() for g_ in (ct_hj, *walk_scan.weight_cotangents(
                grads, d, DT))])


@pytest.mark.parametrize("chunk_rows", [None, 32])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("act,scale,d", [("relu", "identity", 12),
                                         ("tanh", "tanh", 12),
                                         ("selu", "identity", 70)])
def test_plain_records_backward_matches_jax_and_autograd(K, act, scale, d,
                                                         chunk_rows):
    """Row 8's data flow in plain PyTorch (the records of every cell, the
    weight sums over the M B record rows in chunks of 32 or of the launch
    plan's size, the chunks added in order) against the JAX package's VJP
    (Pallas interpret mode) and autograd through walk_gaps_reference, at
    the existing test's tolerance; padded slots and the endpoint slot get
    no jump cotangent."""
    case = make_case(K, d, seed=K * d + 1)
    ref, ref_grads = jax_side(case, act, scale)
    auto, auto_grads = port_side(case, act, scale)
    out, grads = records_side(case, act, scale, chunk_rows)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, auto, **TOL)
    for name, a, b, c in zip(("h_jump", "W1", "b1", "W2", "b2"), grads,
                             ref_grads, auto_grads):
        for other in (b, c):
            np.testing.assert_allclose(
                a, other, err_msg=name, rtol=1e-5,
                atol=1e-6 * max(1.0, np.abs(other).max()))
    hj_grad = grads[0]
    assert np.all(hj_grad[:, 2, 3:] == 0) and np.all(hj_grad[:, 3, 4:] == 0)
    assert np.all(hj_grad[:, 1, -1] == 0)


def test_slot_cells_and_split():
    mask = torch.tensor([[True, True, False]])
    g = torch.tensor([[0, 25, 25]])
    reset, read = walk_scan.slot_cells(mask, g, 20)
    assert reset.tolist() == [[0, 20, -1]] and read.tolist() == [[0, 20, 20]]
    assert reset.dtype == read.dtype == torch.int32
    w1 = torch.randn(2, 4, 7)
    b1 = torch.randn(2, 4)
    w1_io, cvec, w2_io, _ = walk_scan.split_walk_weights(
        (w1, b1, torch.randn(2, 4, 4), torch.randn(2, 4)), 0.01)
    assert w1_io.shape == (2, 7, 4) and w2_io.shape == (2, 4, 4)
    torch.testing.assert_close(cvec, 0.01 * w1[:, :, -1] + b1)


def test_wrapper_refuses_other_devices_and_widths():
    case = make_case(1, 12)
    times, x, mask, hj, weights, _ = case
    args = (torch.tensor(hj), torch.tensor(x), torch.tensor(times),
            torch.tensor(mask), torch.zeros(B, N, dtype=torch.int64),
            [torch.tensor(w) for w in weights], DT, M, "relu", "identity")
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        walk_scan.walk_gaps_fused(*meta[:5], [w.to("meta") for w in args[5]],
                                  *meta[6:])
    assert walk_scan.walk_scan_available(1, "relu", 0.0, "identity", 1, 50)
    assert not walk_scan.walk_scan_available(1, "relu", 0.0, "identity", 2, 50)
    assert not walk_scan.walk_scan_available(1, "relu", 0.1, "identity", 1, 50)
    assert not walk_scan.walk_scan_available(2, "relu", 0.0, "identity", 1, 50)
    assert not walk_scan.walk_scan_available(1, "relu", 0.0, "identity", 1,
                                             walk_scan.MAX_HIDDEN + 1)
