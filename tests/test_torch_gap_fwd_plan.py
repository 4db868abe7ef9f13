"""The launch plan and the row order of rows 2-3 (the gap loop's training
forward, njode_tpu_torch/ops/gap_scan.py ``gap_fwd_plan``,
csrc/gap_train.cu ``gap_fwd_kernel``).

The plan fits the H100's 227 KB of shared memory at every width, mirrors
the source's constants, shared bytes and scratch, admits every shape the
forward it replaced admitted, and reaches only compiled instances.  The
forward sorts the rows as the backward does (``gap_bwd_order``) and takes
the same long rows, so the two kernels walk one schedule; past the sort's
keys it widens the key by a whole factor.  That a row's outputs do not
depend on its walker or on the other rows is held on the card
(chip_smoke.py: the forward on permuted rows and on subsets of the rows
that move rows between the groups and the single warps bitwise equal, and
the pair at stride 1 and at stride 8 bitwise equal); here the plain pair
shows the same invariance of the algebra.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from njode_tpu_torch.ops import gap_scan

SMEM = 232_448
CSRC = Path(gap_scan.__file__).parent / "csrc"
SRC = (CSRC / "gap_train.cu").read_text()


def source_constant(name):
    return int(re.search(rf"\b{name} = (\d+)", SRC).group(1))


def r32(x):
    return -(-x // 32) * 32


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("n_sub", [1, 10, 16, 17, 100, 1000, 1024, 5000,
                                   100_000])
def test_gap_fwd_plan_admits_every_old_shape(K, n_sub):
    """The forward it replaced took every width 1-128, K_h, rows, n_sub and
    stride 1-64: the new plan exists at each, within the shared memory, its
    keys within the sort's bins, on the H100's grid and on a narrower one."""
    strides = {gap_scan.residual_stride(n_sub), 1, 3, 4, 8, 16, 64}
    for d in range(1, gap_scan.MAX_HIDDEN + 1):
        for stride in strides:
            for R in (1, 16, 2304, 18000):
                for blocks in (gap_scan.GAP_FWD_BLOCKS, 2):
                    p = gap_scan.gap_fwd_plan(d, R, n_sub, stride, K, blocks)
                    assert p is not None, (d, n_sub, stride, R)
                    assert p.smem <= SMEM
                    assert 2 <= p.nbins <= gap_scan.GAP_BWD_BINS
                    assert -(-n_sub // p.key_div) + 1 == p.nbins


def test_gap_fwd_plan_at_the_forced_shapes():
    """Row 3 at the forced production shape (2,304 gaps, d_h 50, n_sub 100,
    stride 8), row 2 at dt 0.1 (n_sub 10, stride 1) and 18,000 rows at d_h
    128, K_h 2: groups of 4 warps, 8 warps a block, the long threshold 1 /
    2 (the backward's), a block an SM, the shared bytes and the scratch
    written out."""
    p = gap_scan.gap_fwd_plan(50, 2304, 100, 8, 1)
    assert (p.wpt, p.warps, p.blocks) == (4, 8, 132)
    assert gap_scan.GAP_BWD_LONG == (1, 2)
    assert (p.nbins, p.key_div) == (101, 1)
    assert p.ints() == [132, 101, 1]
    # planes, partial products, vectors, keys, 32 words
    assert p.smem == 4 * (2 * 64 * 65 + 2 * 2 * 4 * 64 + 8 * 64 + 1024 + 32)
    # counts, order, sorted counts; 132 x 101 key counts, 101 totals; two
    # counters a network
    assert p.scratch == 3 * 2304 + r32(132 * 101) + 128 + 32
    p = gap_scan.gap_fwd_plan(50, 2304, 10, 1, 1)
    assert (p.nbins, p.key_div) == (11, 1)
    assert p.scratch == 3 * 2304 + r32(132 * 11) + 32 + 32
    p = gap_scan.gap_fwd_plan(128, 18000, 100, 8, 2)
    assert p.smem == 4 * (2 * 128 * 129 + 2 * 2 * 4 * 128 + 8 * 128 + 1024
                          + 32) <= SMEM
    assert p.scratch == 3 * r32(18000) + r32(132 * 101) + 128 + 32
    assert gap_scan.gap_fwd_plan(129, 16, 100, 8) is None
    assert gap_scan.gap_fwd_plan(50, 16, 100, 65) is None
    assert gap_scan.gap_fwd_plan(50, 16, 100, 8, K=3, blocks=2) is None


@pytest.mark.parametrize("n_sub,stride,key_div,nbins", [
    (1023, 8, 1, 1024), (1024, 8, 8, 129), (1024, 1, 8, 129),
    (1100, 8, 8, 139), (8184, 8, 8, 1024), (8185, 8, 16, 513),
    (1100, 3, 9, 124), (16368, 16, 16, 1024), (100_000, 8, 104, 963)])
def test_gap_fwd_keys_past_the_bins(n_sub, stride, key_div, nbins):
    """The forward's sort key is the substep count up to GAP_BWD_BINS - 1
    substeps, then the backward's segment count (8 substeps at strides 1, 4
    and 8, 9 at 3, 16 at 16), and past GAP_BWD_BINS - 1 segments a whole
    multiple of the segment, so that the keys always fit the bins (where
    the backward refuses the shape)."""
    assert gap_scan.gap_fwd_key_div(n_sub, stride) == key_div
    p = gap_scan.gap_fwd_plan(50, 100, n_sub, stride)
    assert (p.key_div, p.nbins) == (key_div, nbins)
    bp = gap_scan.gap_bwd_plan(50, 100, n_sub, stride)
    if bp is not None:
        assert bp.nbins == p.nbins
        assert key_div == (gap_scan.bwd_segment(stride) if bp.key_seg else 1)


def test_gap_fwd_plan_mirrors_the_source():
    """``_gap_fwd_smem_bytes`` and the plan's constants against
    csrc/gap_train.cu (``fwd_smem_bytes``, ``kFwdWarps``, ``kGroup``,
    ``kBins``, ``kFwdBlocksPerSm``, the long threshold, ``fwd_layout``,
    ``fwd_key_div``), the shared sum written out at every width."""
    assert source_constant("kFwdWarps") == gap_scan.GAP_FWD_WARPS
    assert source_constant("kGroup") == gap_scan.GAP_BWD_WPT
    assert source_constant("kBins") == gap_scan.GAP_BWD_BINS
    assert source_constant("kFwdBlocksPerSm") == gap_scan.GAP_FWD_BLOCKS_PER_SM
    assert "__launch_bounds__(kWarp * kFwdWarps, kFwdBlocksPerSm)" in SRC
    assert gap_scan.GAP_FWD_BLOCKS == 132 * gap_scan.GAP_FWD_BLOCKS_PER_SM
    assert (source_constant("kLongNum"), source_constant("kLongDen")) == \
        gap_scan.GAP_BWD_LONG
    assert "const int thr = (top * kLongNum + kLongDen - 1) / kLongDen;" in SRC
    assert SRC.count("long_rows(s_key, s_misc[8]);") == 2
    assert "(size_t)kFwdWarps * hp + kBins + 32) *" in SRC
    assert "L.ints = L.ctr + round32(2LL * K);" in SRC
    assert "return L * ((n_seg + kBins - 2) / (kBins - 1));" in SRC
    assert ("nbins != (n_sub + kd - 1) / kd + 1 || nbins > kBins || blocks "
            "< K") in SRC
    for d in range(1, gap_scan.MAX_HIDDEN + 1):
        hp = 64 if d <= 64 else 128
        want = 4 * (2 * hp * (hp + 1) + 2 * 2 * 4 * hp + 8 * hp + 1024 + 32)
        assert gap_scan._gap_fwd_smem_bytes(d) == want <= SMEM, d


def compiled_gap_fwd_instances():
    """(columns a lane, relu/identity compiled in) of csrc/gap_train.cu's
    forward instances, read from its launch macro's uses (one cooperative
    launch each)."""
    assert "cudaLaunchCooperativeKernel((const void*)gap_fwd_kernel<C, RI_>" \
        in SRC
    return {(int(c), ri == "true") for c, ri in re.findall(
        r"NJODE_GAP_FWD\((\d), (true|false)\)", SRC)}


def test_gap_fwd_plans_reach_only_compiled_instances():
    """Every width 1-128 takes a plane of 64 or 128 rows, 2 or 4 columns a
    lane, with relu/identity compiled in or not: exactly the instances the
    source launches (held to 0 spill bytes on the card)."""
    reached = {((64 if d <= 64 else 128) // 32, ri)
               for d in range(1, gap_scan.MAX_HIDDEN + 1)
               for ri in (True, False)
               if gap_scan.gap_fwd_plan(d, 16, 100, 8) is not None}
    assert compiled_gap_fwd_instances() == reached == {
        (2, True), (2, False), (4, True), (4, False)}


def bwd_long_rows(counts, n_sub, stride):
    """Row 5's long rows (csrc/gap_train.cu ``long_rows`` with kLongNum /
    kLongDen on the backward's keys)."""
    seg = gap_scan.bwd_segment(stride)
    key = counts if n_sub + 1 <= gap_scan.GAP_BWD_BINS else -(-counts // seg)
    top = int(key.max())
    num, den = gap_scan.GAP_BWD_LONG
    return int((key >= max(-(-top * num // den), 1)).sum()) if top else 0


def forced_counts(seed, R, dt, n_sub, long_gap=None):
    """Substep counts of gaps like a forced minibatch's: observation times
    on a 0.01 grid, gaps of 0 to 0.3, and optionally one long gap."""
    rng = np.random.default_rng(seed)
    t0 = torch.tensor(np.floor(rng.uniform(0, 50, R)) * 0.01,
                      dtype=torch.float32)
    gap = torch.tensor(np.where(rng.uniform(size=R) < 0.1, 0.0,
                                rng.exponential(0.1, R)), dtype=torch.float32)
    if long_gap is not None:
        gap[R // 3] = long_gap
    counts, _ = gap_scan.gap_substep_counts(t0, t0 + gap, dt, n_sub)
    return counts


@pytest.mark.parametrize("dt,n_sub,stride,long_gap", [
    (0.01, 100, 8, None), (0.01, 100, 8, 5.0), (0.1, 10, 1, None),
    (0.01, 100, 1, None), (0.001, 1100, 8, 2.0), (0.001, 1100, 8, None),
    (0.0001, 9000, 8, 1.5)])
def test_gap_fwd_order_is_the_backwards(dt, n_sub, stride, long_gap):
    """At the forced shapes (2,304 gaps at dt 0.01 and 0.1, with and without
    one gap of the whole budget) and past GAP_BWD_BINS (n_sub 1,100: keyed
    by segment count), the forward's order is ``gap_bwd_order``'s and its
    long rows are the backward's; past the backward's reach (n_sub 9,000)
    the order stays longest first by a coarser key."""
    counts = forced_counts(int(n_sub + 10 * stride), 2304, dt, n_sub,
                           long_gap)
    order, n_long = gap_scan.gap_fwd_order(counts, n_sub, stride)
    if gap_scan.gap_bwd_plan(50, 2304, n_sub, stride) is not None:
        seg = gap_scan.bwd_segment(stride)
        assert torch.equal(order, gap_scan.gap_bwd_order(counts, n_sub, seg))
        assert n_long == bwd_long_rows(counts, n_sub, stride)
    cs = counts[order]
    key_div = gap_scan.gap_fwd_key_div(n_sub, stride)
    keys = -(-cs // key_div)
    assert bool((keys[:-1] >= keys[1:]).all())          # longest first
    assert torch.equal(torch.sort(order).values, torch.arange(2304))
    if n_long:
        assert int(keys[n_long - 1]) >= -(-int(keys[0]) // 2)
    if n_long < 2304:
        assert int(keys[n_long]) < max(-(-int(keys[0]) // 2), 1)


def test_gap_fwd_order_of_rows_without_substeps():
    """All-zero counts: no long row, the rows in row order."""
    counts = torch.zeros(37, dtype=torch.int64)
    order, n_long = gap_scan.gap_fwd_order(counts, 100, 8)
    assert n_long == 0 and torch.equal(order, torch.arange(37))


@pytest.mark.parametrize("act,scale", [("relu", "identity"),
                                       ("tanh", "tanh"),
                                       ("selu", "sigmoid")])
def test_plain_pair_is_stride_independent(act, scale):
    """The plain pair at stride 1 and at stride CK on one input: h_L, t_L,
    the checkpoints at the shared positions and every backward output
    bitwise equal, as the kernels are on the card (the same algebra per
    substep, whatever the stride)."""
    rng = np.random.default_rng(4)
    K, R, d, n_sub, dt = 2, 33, 6, 40, 0.01

    def t(*shape, scale_=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale_,
                            dtype=torch.float32)
    t0 = torch.tensor(np.floor(rng.uniform(0, 50, R)) * dt,
                      dtype=torch.float32)
    args = (t(K, R, d, scale_=0.5), t(K, R, d, scale_=0.1), t0,
            t0 + torch.tensor(rng.uniform(0, 0.5, R), dtype=torch.float32),
            t(K, d, d, scale_=0.3), t(K, d, scale_=0.1), t(K, d, d, scale_=0.3),
            t(K, d, scale_=0.1))
    ct = t(K, R, d)
    ck = gap_scan.CK
    f1 = gap_scan.gap_train_forward_reference(*args, dt, n_sub, 1, act, scale)
    fc = gap_scan.gap_train_forward_reference(*args, dt, n_sub, ck, act,
                                              scale)
    for a, b in ((f1[0], fc[0]), (f1[1], fc[1]), (f1[2][::ck], fc[2]),
                 (f1[3][::ck], fc[3])):
        assert torch.equal(a, b)
    bargs = (ct, args[1], args[3], *args[4:])
    b1 = gap_scan.gap_train_backward_reference(*bargs, f1[2], f1[3], dt,
                                               n_sub, 1, act, scale)
    bc = gap_scan.gap_train_backward_reference(*bargs, fc[2], fc[3], dt,
                                               n_sub, ck, act, scale)
    for a, b in zip(b1, bc):
        assert torch.equal(a, b)
