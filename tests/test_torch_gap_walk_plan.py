"""The launch plans of rows 1, 4-5, 7 and 8.

Row 1 (njode_tpu_torch/ops/gap_scan.py ``gap_plan``, csrc/gap_scan.cu) and
row 8 (njode_tpu_torch/ops/walk_scan.py ``walk_bwd_plan``,
csrc/walk_scan.cu): each plan fits the H100's 227 KB of shared memory, its
shared bytes mirror the source's layout, it admits every shape the kernels
it replaced admitted (their gates, frozen below), and row 1's source
compiles exactly the instances its plans reach.  That the kernel runs every
row exactly once is held on the card (chip_smoke.py's phase 3: every row's
h_L and t_L against the plain version).
"""

import itertools
import re
from pathlib import Path

import pytest
import torch

from njode_tpu_torch.ops import gap_scan, walk_scan

SMEM = 232_448
CSRC = Path(gap_scan.__file__).parent / "csrc"


def old_gap_fits(d_h, scale):
    """The gate of row 1's first kernel, frozen: h, hid, base (and s(h))
    rows of 4 rows a warp, warps halving from 8 to 1."""
    n_buf = 3 if scale == "identity" else 4
    return n_buf * 4 * d_h * 4 <= SMEM


def old_walk_fits(d, N, scale):
    """The gates of rows 7-8's first kernels, frozen: the forward's and the
    backward's row buffers of 4 rows a block and the rows' slot cells,
    weights unstaged."""
    ident = scale == "identity"
    fwd = ((2 if ident else 3) * 4 * d + 8 * N) * 4
    bwd = (2 * d * d + 4 * d + (6 if ident else 7) * 4 * d + 8 + 8 * N) * 4
    return fwd <= SMEM and bwd <= SMEM


def source_constant(name, source):
    m = re.search(rf"\b{name} = (\d+)", (CSRC / source).read_text())
    return int(m.group(1))


@pytest.mark.parametrize("scale", gap_scan.SCALINGS)
def test_gap_plan_admits_every_old_width(scale):
    """Wherever the first kernel had a plan, row 1 has one within the
    shared memory; the plan's tile covers d_h with at most 32 lanes a
    warp, rows of whole 16 bytes, staged planes as wide as the lanes'
    columns."""
    for d_h in range(1, 5001):
        plan = gap_scan.gap_plan(d_h, scale)
        if not old_gap_fits(d_h, scale):
            continue
        assert plan is not None and plan.smem <= SMEM, d_h
        assert plan.wide == (d_h > gap_scan.GAP_WIDE)
        if not plan.wide:
            assert plan.lanes * plan.tc >= d_h > (plan.lanes - 1) * plan.tc
            assert plan.groups == 32 // plan.lanes
        else:
            assert (plan.tc, plan.lanes, plan.groups) == (8, 32, 1)
        assert plan.ldx % 4 == 0 and plan.ldx >= d_h
        if plan.stage:
            assert plan.ldw == plan.lanes * plan.tc
            assert 8 * d_h * plan.ldw <= gap_scan.GAP_STAGE_BYTES
        assert plan.tr == (gap_scan.GAP_TR_STAGED if plan.stage
                           else gap_scan.GAP_TR_UNSTAGED)
        assert plan.warps in (1, 2, 4, 8)


def test_gap_plan_at_the_serving_shapes():
    """The production width (10 lanes x 5 columns, 3 row groups a warp,
    weights staged) and the wide serving case (a full warp of 8 columns a
    lane, weights through L1)."""
    p = gap_scan.gap_plan(50, "identity")
    assert (p.tc, p.lanes, p.groups, p.warps, p.stage, p.wide) == (
        5, 10, 3, 8, True, False)
    assert (p.ldx, p.ldw) == (52, 50)
    p = gap_scan.gap_plan(256, "identity")
    assert (p.tc, p.lanes, p.groups, p.stage, p.wide) == (8, 32, 1, False,
                                                          False)
    assert gap_scan.gap_plan(0, "identity") is None
    assert p.tr == 4
    p = gap_scan.gap_plan(50, "identity")
    assert p.ints() == [5, 10, 3, 8, 52, 50, 1, 0] and p.tr == 2


def test_gap_plan_smem_mirrors_the_source():
    """``_gap_smem_bytes`` against csrc/gap_scan.cu's ``smem_bytes_of``,
    written out: each warp's h, hid (and s(h)) rows, the sort's keys and
    order (kMaxPass each), its bins (kBins) and counter words, the two
    staged planes of d_h rows."""
    assert source_constant("kMaxPass", "gap_scan.cu") == gap_scan.GAP_MAX_PASS
    assert source_constant("kBins", "gap_scan.cu") == gap_scan.GAP_BINS
    assert source_constant("kWideCols", "gap_scan.cu") == gap_scan.GAP_WIDE
    assert (source_constant("kTrStaged", "gap_scan.cu")
            == gap_scan.GAP_TR_STAGED)
    assert (source_constant("kTrUnstaged", "gap_scan.cu")
            == gap_scan.GAP_TR_UNSTAGED)
    for d_h, scale in itertools.product((1, 12, 50, 128, 256, 300, 4000),
                                        gap_scan.SCALINGS):
        p = gap_scan.gap_plan(d_h, scale)
        nbuf = 2 if scale == "identity" else 3
        want = 4 * (p.warps * nbuf * p.groups * p.tr * p.ldx + 2 * 2048 + 128
                    + 4 + (2 * d_h * p.ldw if p.stage else 0))
        assert p.smem == want, (d_h, scale)


def test_gap_entry_admits_the_old_ranges():
    """csrc/gap_scan.cu's entry refuses only what the first kernel's did:
    K outside 1..65,535, R < 0, d_h < 1, n_sub < 0 (its guard, read from
    the source); R 0 launches one block that does nothing, and the plan
    does not depend on K, R or n_sub."""
    src = (CSRC / "gap_scan.cu").read_text()
    assert ("K <= 0 || K > 65535 || R < 0 || d_h <= 0 || n_sub < 0"
            in " ".join(src.split()))
    assert "groups > 0 ? groups : 1" in src
    assert gap_scan.gap_plan(50) == gap_scan.gap_plan(50, "identity")


def compiled_gap_instances():
    """The (TC, staged, wide) instances csrc/gap_scan.cu's entry launches,
    read from its ``NJODE_GAP(C, STG, WD)`` dispatch."""
    src = (CSRC / "gap_scan.cu").read_text()
    found = re.findall(r"NJODE_GAP\((\d+), (true|false), (true|false)\);",
                       src)
    return {(int(c), st == "true", wd == "true") for c, st, wd in found}


def plan_instance(plan):
    return (plan.tc, plan.stage, plan.wide)


@pytest.mark.parametrize("scale", gap_scan.SCALINGS)
def test_gap_plans_reach_only_compiled_instances(scale):
    """Every plan gap_plan makes (d_h 1 to 5,000) launches an instance the
    source compiles."""
    have = compiled_gap_instances()
    for d_h in range(1, 5001):
        plan = gap_scan.gap_plan(d_h, scale)
        if plan is not None:
            assert plan_instance(plan) in have, (d_h, plan)


def test_gap_source_compiles_no_unreachable_instance():
    """Each compiled instance is some plan's: staged TC 1, 2, 4, 5, 8,
    unstaged TC 4, 5, 8, wide TC 8 (nine, each held to 0 spill bytes on the
    card)."""
    reached = {plan_instance(p) for scale in gap_scan.SCALINGS
               for d_h in range(1, 5001)
               if (p := gap_scan.gap_plan(d_h, scale)) is not None}
    assert compiled_gap_instances() == reached
    assert len(reached) == 9


@pytest.mark.parametrize("rows", [1, 256, 512, 4000])
def test_walk_bwd_plan_admits_every_old_shape(rows):
    """Every walk_scan_available width, at slot counts up to where the first
    kernels' gates closed: row 8 has a plan within the shared memory, a
    row's warps dividing the block's (at most 8 rows, one named barrier
    each), the weight sums' chunks whole tiles of 32 rows covering the M B
    record rows."""
    for d, N, scale in itertools.product(
            range(1, walk_scan.MAX_HIDDEN + 1),
            (2, 3, 10, 100, 1000, 2000, 2600, 5000, 7000, 10000),
            ("identity", "tanh")):
        if not old_walk_fits(d, N, scale):
            continue
        for M in (0, 1, 100):
            plan = walk_scan.walk_bwd_plan(d, rows, N, M)
            assert plan is not None and plan.smem <= SMEM, (d, N, M)
            assert plan.wpt in (1, 2, 4) and plan.warps % plan.wpt == 0
            assert plan.warps <= walk_scan.BWD_MAX_WARPS
            assert plan.chunk_rows % 32 == 0
            assert plan.chunk_rows >= walk_scan.DW_MIN_CHUNK
            assert plan.chunks <= walk_scan.DW_MAX_CHUNKS
            mb = M * rows
            assert plan.chunks * plan.chunk_rows >= mb
            assert (plan.chunks - 1) * plan.chunk_rows < mb or mb == 0


def test_walk_bwd_plan_at_the_production_shape_and_the_source():
    """256 rows, H 50, N 10, M 100: 4 warps a row at K_h 1 and 2, 2 rows a
    block, 200 chunks of 128 record rows; the shared bytes as
    csrc/walk_scan.cu's ``walk_smem_bytes`` counts them, written out; the
    sums' block (one thread a 4 x 8 output tile) within its bound at every
    width."""
    for K in (1, 2):
        plan = walk_scan.walk_bwd_plan(50, 256, 10, 100, K)
        assert plan.ints() == [4, 8, 128] and plan.chunks == 200
        assert plan.smem == 4 * (2 * 64 * 65 + 2 * 2 * 4 * 64 + 2 * 2 * 10)
    assert walk_scan.walk_bwd_plan(50, 384, 10, 100, 2).wpt == 2
    assert walk_scan.walk_bwd_plan(50, 2000, 10, 100, 2).wpt == 1
    assert walk_scan.walk_bwd_plan(129, 256, 10, 100) is None
    cap = source_constant("kDwMaxThreads", "walk_scan.cu")
    for d in range(1, walk_scan.MAX_HIDDEN + 1):
        tiles = -(-(d + 3) // 4) * -(-d // 8)
        assert -(-tiles // 32) * 32 <= cap


# ---------------------------------------------------------------- rows 4-5

def _r32(x):
    return -(-x // 32) * 32


def old_gap_bwd_fits(d, stride):
    """The gate of rows 4-5's first kernel, frozen (csrc/gap_train.cu's
    ``bwd_rows_bytes`` of one row a warp, 4 rows a block): the weight
    cotangents' accumulator, five row buffers and the segment's states."""
    return (2 * d * d + 5 * 4 * d + stride * 4 * (d + 1)) * 4 <= SMEM


@pytest.mark.parametrize("K", [1, 2])
def test_gap_bwd_plan_admits_every_old_shape(K):
    """Every width and residual stride at which the first backward had a
    plan, at the n_sub whose stride ``residual_stride`` picks (GapScan's
    shapes) and at the stride A/B's strides 1, 4, 8, 16 (n_sub up to
    1,000): row 5 has a plan within the shared memory, sort keys that fit,
    chunks of whole 32-row tiles covering the rows."""
    for d in range(1, gap_scan.MAX_HIDDEN + 1):
        for n_sub in (1, 10, 16, 17, 100, 1000, 5000):
            strides = {gap_scan.residual_stride(n_sub)}
            if n_sub <= 1000:
                strides |= {1, 4, 8, 16}
            for stride in strides:
                if not old_gap_bwd_fits(d, stride):
                    continue
                for R in (1, 16, 2304, 18000):
                    p = gap_scan.gap_bwd_plan(d, R, n_sub, stride, K)
                    assert p is not None and p.smem <= SMEM, (d, n_sub, R)
                    assert p.nbins <= gap_scan.GAP_BWD_BINS
                    assert p.chunk_rows % 32 == 0
                    assert p.chunks * p.chunk_rows >= R
                    assert (p.chunks - 1) * p.chunk_rows < R


def test_gap_bwd_plan_at_the_forced_shapes():
    """Row 5 at the forced production shape (2,304 gaps, d_h 50, n_sub 100,
    stride 8), row 4 at dt 0.1 (n_sub 10, stride 1) and the step buffer's
    largest case of chip_smoke.py (18,000 rows, d_h 128, K_h 2): groups of 4
    warps, 8 warps a block, the long threshold 1 / 2, a block an SM, the
    shared bytes and the scratch written out."""
    p = gap_scan.gap_bwd_plan(50, 2304, 100, 8, 1)
    assert (p.wpt, p.warps, p.long_num, p.long_den, p.blocks) == (4, 8, 1, 2,
                                                                  132)
    assert (p.chunk_rows, p.chunks, p.nbins, p.key_seg) == (32, 72, 101,
                                                            False)
    assert p.ints() == [132, 32, 101, 0] and p.seg == 8
    assert p.smem == 4 * (2 * 64 * 65 + 2 * 2 * 4 * 64 + 2 * 32 * 56
                          + 8 * 64 + 2 * 1024 + 32)
    # counts, order, sorted counts; 132 x 101 key counts and 101 totals,
    # each rounded up to 32; two step buffers; 72 chunk accumulators; each
    # warp's 8 slots of 2 x 64 + 32 floats
    step = 2 * 4 * 8 * 2304 * 50
    assert p.scratch == (3 * 2304 + 13344 + 128 + step + 72 * 2 * 2500
                         + 132 * 8 * 8 * 160)
    p = gap_scan.gap_bwd_plan(50, 2304, 10, 1, 1)
    assert (p.seg, p.nbins, p.chunk_rows) == (8, 11, 32)
    assert p.scratch == (3 * 2304 + _r32(132 * 11) + 32 + step
                         + 72 * 2 * 2500 + 132 * 8 * 8 * 160)
    p = gap_scan.gap_bwd_plan(128, 18000, 100, 8, 2)
    assert (p.chunk_rows, p.chunks) == (160, 113)
    assert p.smem == 4 * (2 * 128 * 129 + 2 * 2 * 4 * 128 + 2 * 32 * 128
                          + 8 * 128 + 2 * 1024 + 32) <= SMEM
    # one segment's records, double-buffered: 2 x 8 x K R 4 d floats
    assert p.scratch > 2 * 8 * 2 * 18000 * 4 * 128
    assert gap_scan.gap_bwd_plan(50, 2304, 100, 8, 1, blocks=264).chunk_rows \
        == 32
    assert gap_scan.gap_bwd_plan(129, 16, 100, 8) is None
    assert gap_scan.gap_bwd_plan(50, 16, 100, 65) is None
    assert gap_scan.gap_bwd_plan(50, 16, 100, 8, K=3, blocks=2) is None


def test_gap_bwd_plan_keys_past_the_bins():
    """The sort keys are the substep counts up to GAP_BWD_BINS - 1 substeps,
    then the counts of segments (the stride's multiple from CK up: 8 at
    strides 1, 4 and 8, 16 at 16); a plan whose segments outnumber the bins
    is refused."""
    assert [gap_scan.bwd_segment(s) for s in (1, 2, 3, 4, 8, 16, 64)] == [
        8, 8, 9, 8, 8, 16, 64]
    p = gap_scan.gap_bwd_plan(50, 100, 1023, 8)
    assert (p.seg, p.nbins, p.key_seg) == (8, 1024, False)
    p = gap_scan.gap_bwd_plan(50, 100, 1024, 8)
    assert (p.nbins, p.key_seg) == (129, True)
    assert gap_scan.gap_bwd_plan(50, 100, 1024, 1).nbins == 129
    assert gap_scan.gap_bwd_plan(50, 100, 8184, 8).nbins == 1024
    assert gap_scan.gap_bwd_plan(50, 100, 8185, 8) is None
    assert gap_scan.gap_bwd_plan(50, 100, 16368, 16).nbins == 1024


def test_gap_bwd_plan_mirrors_the_source():
    """``_gap_bwd_smem_bytes`` and the plan's constants against
    csrc/gap_train.cu (``bwd_smem_bytes``, ``kBwdWarps``, ``kGroup``,
    ``kLongNum`` / ``kLongDen``, ``kBins``, ``kDwRows``, ``kMaxStride``,
    ``kMaxBlocks``), the shared sum written out at every width."""
    src = "gap_train.cu"
    assert source_constant("kBwdWarps", src) == gap_scan.GAP_BWD_WARPS
    assert source_constant("kGroup", src) == gap_scan.GAP_BWD_WPT
    assert source_constant("kBins", src) == gap_scan.GAP_BWD_BINS
    assert source_constant("kDwRows", src) == gap_scan.GAP_BWD_DW_ROWS
    assert source_constant("kMaxStride", src) == gap_scan.MAX_STRIDE
    assert source_constant("kSegMin", src) == gap_scan.CK
    text = (CSRC / src).read_text()
    assert (f"kLongNum = {gap_scan.GAP_BWD_LONG[0]}, kLongDen = "
            f"{gap_scan.GAP_BWD_LONG[1]}") in text
    assert "kMaxBlocks = 8 * kWarp * 8" in text
    assert 8 * 32 * 8 == gap_scan.GAP_BWD_MAX_BLOCKS
    for d in range(1, gap_scan.MAX_HIDDEN + 1):
        hp = 64 if d <= 64 else 128
        ld = -(-d // 8) * 8
        want = 4 * (2 * hp * (hp + 1) + 2 * 2 * 4 * hp + 2 * 32 * ld
                    + 8 * hp + 2 * 1024 + 32)
        assert gap_scan._gap_bwd_smem_bytes(d) == want <= SMEM, d


def compiled_gap_bwd_instances():
    """The columns a lane of csrc/gap_train.cu's backward instances, read
    from its cooperative launches."""
    src = (CSRC / "gap_train.cu").read_text()
    return {int(c) for c in re.findall(
        r"cudaLaunchCooperativeKernel\(\(const void\*\)gap_bwd_kernel<(\d), (?:true|false)>",
        src)}


def test_gap_bwd_plans_reach_only_compiled_instances():
    """Every width 1-128 takes a plane of 64 or 128 rows, 2 or 4 columns a
    lane: exactly the two instances the source launches (held to 0 spill
    bytes on the card)."""
    reached = {(64 if d <= 64 else 128) // 32
               for d in range(1, gap_scan.MAX_HIDDEN + 1)
               if gap_scan.gap_bwd_plan(d, 16, 100, 8) is not None}
    assert compiled_gap_bwd_instances() == reached == {2, 4}


# ------------------------------------------------------------------ row 7

@pytest.mark.parametrize("rows", [1, 256, 512, 4000])
def test_walk_fwd_plan_admits_every_old_shape(rows):
    """Every walk_scan_available width at slot counts up to where the first
    kernels' gates closed: row 7 has a plan within the shared memory, with
    the backward's groups (a row's warps dividing the block's)."""
    for d, N, scale in itertools.product(
            range(1, walk_scan.MAX_HIDDEN + 1),
            (2, 3, 10, 100, 1000, 2000, 2600, 5000, 7000, 10000),
            ("identity", "tanh")):
        if not old_walk_fits(d, N, scale):
            continue
        for M in (0, 1, 100):
            plan = walk_scan.walk_fwd_plan(d, rows, N, M)
            assert plan is not None and plan.smem <= SMEM, (d, N, M)
            assert plan.wpt in (1, 2, 4) and plan.warps % plan.wpt == 0
            assert plan.warps <= walk_scan.BWD_MAX_WARPS
            bwd = walk_scan.walk_bwd_plan(d, rows, N, M)
            assert (plan.wpt, plan.warps, plan.smem) == (bwd.wpt, bwd.warps,
                                                         bwd.smem)


@pytest.mark.parametrize("K,rows,wpt", [(1, 512, 4), (1, 513, 2), (1, 1024, 2),
                                        (1, 1025, 1), (2, 256, 4), (2, 257, 2),
                                        (2, 512, 2), (2, 513, 1)])
def test_walk_fwd_plan_switches_with_the_walk_rows(K, rows, wpt):
    """A row's warps switch at 512 / 513 and 1,024 / 1,025 walk rows (B
    K_h), the cases chip_smoke.py's phase 12 runs on the card."""
    assert walk_scan.walk_fwd_plan(50, rows, 10, 100, K).wpt == wpt


def test_walk_fwd_plan_at_the_production_shape_and_the_source():
    """256 rows, H 50, N 10, M 100 at K_h 2: 4 warps a row, 2 rows a block,
    the shared bytes as csrc/walk_scan.cu's ``walk_smem_bytes`` counts
    them, written out; the source launches the forward with the plan's
    bytes and compiles <2 or 4 columns a lane, relu/identity, residuals>
    only."""
    plan = walk_scan.walk_fwd_plan(50, 256, 10, 100, 2)
    assert plan.ints() == [4, 8]
    assert plan.smem == 4 * (2 * 64 * 65 + 2 * 2 * 4 * 64 + 2 * 2 * 10)
    assert walk_scan.walk_fwd_plan(129, 256, 10, 100) is None
    assert walk_scan.walk_fwd_plan(50, 256, 1, 100) is None
    src = (CSRC / "walk_scan.cu").read_text()
    assert "walk_smem_bytes(d, N, wpt, warps)" in src
    found = set(re.findall(r"NJODE_WALK_FWD_SV\((\d), (true|false)\)", src))
    assert found == {("2", "true"), ("2", "false"), ("4", "true"),
                     ("4", "false")}
