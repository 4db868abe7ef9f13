"""The launch plans of rows 1 and 8.

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
    csrc/walk_scan.cu's ``bwd_smem_bytes`` counts them, written out; the
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
