"""Whole-gap Euler integration: the substep loop as one CUDA kernel.

Port of ``njode_tpu/ops/gap_scan.py``.  With ``dt_ode_step`` set (the
production recipes: 0.01), every inter-observation gap integrates with up to
``max_substeps`` predicated Euler substeps, then one final partial step to
exactly the target time (reference models/jump_ode.py:196-202).  The
serving path (``predict_at``, ``NJODEFilter.predict``) runs this for every
query row.

Kernel: ``csrc/gap_scan.cu`` (``njode_gap_scan_fwd``), which replaces the
TPU kernel ``njode_tpu/ops/gap_scan.py:_fwd_kernel_lean`` (primal only, no
residuals).  It runs the whole full-step loop on chip; the hoisted ``base``
and the final partial step stay in PyTorch around it, as the JAX package
leaves them to XLA.  On the H100 the loop is bound by the two (d_h x d_h)
f32 products per substep (4 d_h^2 flops per row and substep) and by how the
rows, whose substep counts differ widely within a request, are spread over
warps and SMs.  The design: one wave of blocks, each owning a strided sample
of the rows, which it sorts by their substep count (longest first) before its
warps take groups of rows of about equal length, the longest rows one a
row group; each warp computes a register micro-tile of TR rows x TC columns
per lane over 32-bit broadcast loads of the weights (staged in shared
memory where they fit) and of the rows.  The launch plan is
:func:`gap_plan`, which mirrors the source's shared-memory layout.  See the
source for the rest.

Feature split (exact algebra of the ODEFunc concat, reference
models/jump_ode.py:52-63; W1 rows are [h, x, t_rel, t_elapsed]):

    pre = [s(h), s(x), t, dt] W1 + b1
        = s(h) W1h  +  t w1t  +  (s(x) W1x + dt w1dt + b1)    # = base

The full steps use the constant ``dt`` as the t_elapsed feature, like the
JAX kernel.  The non-kernel loop of the model uses ``t_new - t_cur``; the two
differ by rounding.  t advances by single f32 adds with the predicate
``(t + dt) < t_target``, so t_L is bitwise the same in the kernel, its plain
version and the JAX kernel.

Weights: :func:`split_weights` cuts the stacked ODEFunc weights once into
:class:`GapWeights`, W1 split by feature rows and both matrices turned to the
(in, out) orientation the kernel reads; the model keeps the result until its
parameters change, so a call copies no weights.

Training (rows 2-5 of the TPU kernel table): ``csrc/gap_train.cu``
replaces ``_fwd_kernel`` (:134) and ``_fwd_kernel_ck`` (:235) with one
forward that stores the state entering every ``stride``-th substep (stride 1
up to ``2 * CK`` substeps, else ``CK``; ``_use_remat``, :126-127), and
``_bwd_kernel`` (:422) and ``_bwd_kernel_ck`` (:295) with one reverse loop
that recomputes each segment from its checkpoint: one cooperative launch
that sorts the rows by their substep count on the device, walks the longest
on groups of warps and the rest one a warp, and sums the weight cotangents
from each segment's records over the whole grid in a fixed order
(:func:`gap_bwd_plan`, its plain pair :func:`gap_bwd_records_reference`).
:class:`GapScan`, a
``torch.autograd.Function``, joins them; its backward returns the
cotangents of h, base, w1h, w1t, w2 and b2 (those of the times are None),
summing the kernel's per-row ``acc_t`` and ``gdh_sum`` over rows into w1t's
and b2's as the JAX package does in XLA (:734-738).

Wrappers: :func:`gap_substeps` launches the primal-only kernel for CUDA
tensors when no gradient is wanted, :class:`GapScan` (the training pair)
when one is, and takes the plain versions (:func:`gap_substeps_reference`,
:func:`gap_train_forward_reference`, :func:`gap_train_backward_reference`)
only for CPU tensors; :func:`integrate_gap_fused` is the model-facing
whole-gap function and :func:`integrate_gap_reference` its plain version.
With ``max_substeps == 0`` nothing launches: only the final partial step
applies (:774-780).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

# the kernel's activation / scaling codes are positions in these tuples
from .activations import (_ACT, _ACT_GRAD, _SCALE, _SCALE_GRAD, SCALINGS,
                          SUPPORTED_ACTS)

# launches in this process, callers may reset them to 0: the primal-only
# kernel (row 1), and the training forward and backward by residual mode,
# "full" (stride 1: rows 2 and 4) and "checkpointed" (rows 3 and 5)
LAUNCHES = 0
LAUNCHES_RES_FWD = {"full": 0, "checkpointed": 0}
LAUNCHES_BWD = {"full": 0, "checkpointed": 0}

# checkpoint interval of the training pair past 2 * CK substeps
# (njode_tpu/ops/gap_scan.py:117-127)
CK = 8
# the training kernels' widest state (csrc/gap_train.cu: 4 columns a lane)
MAX_HIDDEN = 128


# row 1's launch plan (csrc/gap_scan.cu): columns a lane TC from GAP_TCS,
# GAP_WARPS warps a block, a pass of the block's sort holding GAP_MAX_PASS
# rows in GAP_BINS length classes; past GAP_WIDE columns, chunks of 256 (TC
# 8 x 32 lanes).  The weights are staged in shared memory while their two
# planes take at most GAP_STAGE_BYTES; then GAP_TR_STAGED rows a row group
# and the rows of at least 2 / 4 of the pass's longest count one a row group,
# else GAP_TR_UNSTAGED and no long tier (each weight load through L1 serves
# more rows).  The H100 A/B behind them: PERF.md section 6.
GAP_TCS = (1, 2, 4, 5, 8)
GAP_TR_STAGED, GAP_TR_UNSTAGED = 2, 4
GAP_WARPS = 8
GAP_MAX_PASS, GAP_BINS = 2048, 128
GAP_WIDE = 256
GAP_STAGE_BYTES = 64 * 1024
SMEM_BYTES = 232_448           # the H100's opt-in shared memory per block


class GapPlan(NamedTuple):
    """Row 1's launch plan: TC columns a lane (lane l of a row group owns
    columns l, l + L, ...), TR rows a row group (set by the staging), L
    lanes a row group, G row groups a warp, warps a block, the row buffers'
    stride ldx and the staged planes' row length ldw = L TC (floats),
    whether the weights are staged (and the longest rows then run one a row
    group), whether the columns run in 256-wide chunks, and the shared
    bytes."""
    tc: int
    tr: int
    lanes: int
    groups: int
    warps: int
    ldx: int
    ldw: int
    stage: bool
    wide: bool
    smem: int

    def ints(self) -> list[int]:
        """The plan as njode_gap_scan_fwd takes it (TR follows stage)."""
        return [self.tc, self.lanes, self.groups, self.warps, self.ldx,
                self.ldw, int(self.stage), int(self.wide)]


def _gap_smem_bytes(d_h: int, groups: int, tr: int, warps: int, ldx: int,
                    ldw: int, stage: bool, scale_name: str) -> int:
    """csrc/gap_scan.cu's ``smem_bytes_of``: each warp's h, hid (and, unless
    identity scaling, s(h)) rows, the block's sort (keys, order, bins, the
    group counter), and the staged weight planes (d_h rows of ldw)."""
    nbuf = 2 if scale_name == "identity" else 3
    rows = warps * nbuf * groups * tr * ldx
    sort = 2 * GAP_MAX_PASS + GAP_BINS + 4
    planes = 2 * d_h * ldw if stage else 0
    return 4 * (rows + sort + planes)


@functools.lru_cache(maxsize=None)
def gap_plan(d_h: int, scale_name: str = "identity") -> GapPlan | None:
    """Row 1's launch plan for width d_h, or None where no block fits the
    shared memory.  TC is the one of ``GAP_TCS`` that leaves the fewest
    lanes idle (G = 32 // ceil(d_h / TC) row groups a warp), the smaller on
    a tie; past ``GAP_WIDE`` columns, TC 8 over all 32 lanes in chunks.  TR
    follows the staging (``GAP_TR_STAGED``, ``GAP_TR_UNSTAGED``).  Warps
    halve from ``GAP_WARPS`` until the block fits."""
    d_h = int(d_h)
    if d_h < 1:
        return None
    wide = d_h > GAP_WIDE
    if wide:
        tc, lanes, groups = 8, 32, 1
    else:
        best = None
        for tc in GAP_TCS:
            lanes = -(-d_h // tc)
            if lanes > 32:
                continue
            groups = 32 // lanes
            eff = groups * d_h / (32 * tc)
            if best is None or eff > best[0]:
                best = (eff, tc, lanes, groups)
        _, tc, lanes, groups = best
    ldx = -(-d_h // 4) * 4
    ldw = lanes * tc
    stage = not wide and 2 * 4 * d_h * ldw <= GAP_STAGE_BYTES
    tr = GAP_TR_STAGED if stage else GAP_TR_UNSTAGED
    warps = GAP_WARPS

    def need(w):
        return _gap_smem_bytes(d_h, groups, tr, w, ldx, ldw, stage,
                               scale_name)
    while warps > 1 and need(warps) > SMEM_BYTES:
        warps //= 2
    if need(warps) > SMEM_BYTES:
        return None
    return GapPlan(tc, tr, lanes, groups, warps, ldx, ldw, stage, wide,
                   need(warps))


# row 5's launch plan (csrc/gap_train.cu, the backward, row 4 at stride 1):
# GAP_BWD_WARPS warps a block; the long rows (a substep count of at least
# GAP_BWD_LONG[0] / GAP_BWD_LONG[1] of the call's longest, rounded up) walk
# on a group of GAP_BWD_WPT warps, the rest one a warp; the device sort's
# keys are the counts, at most GAP_BWD_BINS of them (else the segment
# counts); the weight sums stage GAP_BWD_DW_ROWS record rows at a time over
# chunks of whole 32-row tiles of sorted rows; the grid is the card's
# resident blocks (GAP_BWD_BLOCKS on an H100 at a block an SM), at most
# GAP_BWD_MAX_BLOCKS.  The residual stride is at most MAX_STRIDE; a segment
# of the walk is the stride's multiple from CK up (bwd_segment).
GAP_BWD_WARPS, GAP_BWD_WPT = 8, 4
GAP_BWD_LONG = (1, 2)
GAP_BWD_BINS = 1024
GAP_BWD_DW_ROWS = 32
GAP_BWD_BLOCKS = 132
GAP_BWD_MAX_BLOCKS = 2048
MAX_STRIDE = 64


class GapBwdPlan(NamedTuple):
    """Row 5's launch plan: warps a long row's group, warps a block, the
    long threshold (a count of at least long_num / long_den of the longest),
    blocks, substeps a segment, sorted rows a chunk of the weight sums and
    their chunks, the sort's keys (nbins, segment counts when key_seg), the
    shared bytes and the scratch floats."""
    wpt: int
    warps: int
    long_num: int
    long_den: int
    blocks: int
    seg: int
    chunk_rows: int
    chunks: int
    nbins: int
    key_seg: bool
    smem: int
    scratch: int

    def ints(self) -> list[int]:
        """The plan as njode_gap_train_bwd takes it."""
        return [self.blocks, self.chunk_rows, self.nbins, int(self.key_seg)]


def _plane_rows(d_h: int) -> int:
    return 64 if d_h <= 64 else 128


def _round32(x: int) -> int:
    return -(-x // 32) * 32


def _gap_bwd_smem_bytes(d_h: int) -> int:
    """csrc/gap_train.cu's ``bwd_smem_bytes``: the W1h and W2 planes (HP x
    (HP + 1)), the two groups' partial-product buffers, the sums' staged A
    and G rows, each warp's vector (HP floats) of a single-warp product, the
    sort's keys and the segments' active rows (GAP_BWD_BINS each), 32
    words."""
    hp, ld = _plane_rows(d_h), -(-d_h // 8) * 8
    return 4 * (2 * hp * (hp + 1)
                + GAP_BWD_WARPS // GAP_BWD_WPT * 2 * GAP_BWD_WPT * hp
                + 2 * GAP_BWD_DW_ROWS * ld + GAP_BWD_WARPS * hp
                + 2 * GAP_BWD_BINS + 32)


def bwd_segment(stride: int) -> int:
    """Substeps a segment of the backward's walk: the residual stride's
    multiple from CK up (csrc/gap_train.cu: kSegMin), so that a call at
    stride 1 meets a grid barrier every CK substeps, not every one."""
    return -(-CK // stride) * stride


def _gap_bwd_scratch_floats(K: int, R: int, d_h: int, seg: int,
                            nbins: int, blocks: int, chunks: int) -> int:
    """csrc/gap_train.cu's ``bwd_layout``: counts, sorted rows and their
    counts, the keys' per-block counts and totals (ints), the two step
    buffers of one segment's records, the chunk accumulators and each
    warp's segment states, each part a whole number of 32 floats but the
    last."""
    seg_warp = seg * (2 * _plane_rows(d_h) + 32)
    return (3 * _round32(R) + _round32(blocks * nbins) + _round32(nbins)
            + _round32(2 * K * 4 * seg * R * d_h)
            + _round32(chunks * K * 2 * d_h * d_h)
            + blocks * GAP_BWD_WARPS * seg_warp)


@functools.lru_cache(maxsize=None)
def gap_bwd_plan(d_h: int, R: int, n_sub: int, stride: int, K: int = 1,
                 blocks: int = GAP_BWD_BLOCKS) -> GapBwdPlan | None:
    """Row 5's (and row 4's) launch plan for K networks of R rows of width
    d_h, n_sub substeps stored every ``stride``, on a grid of ``blocks``
    (the card's resident blocks; the kernel checks them), or None where the
    kernel does not take the shape.  The weight sums' chunks hold
    ceil(R / blocks) sorted rows rounded up to 32 (at least 32), so that
    segment 0's chunks spread over the grid."""
    d_h, R, n_sub, stride, K, blocks = (int(d_h), int(R), int(n_sub),
                                        int(stride), int(K), int(blocks))
    if not (1 <= d_h <= MAX_HIDDEN and R >= 1 and n_sub >= 1
            and 1 <= stride <= MAX_STRIDE and 1 <= K <= blocks
            <= GAP_BWD_MAX_BLOCKS):
        return None
    seg = bwd_segment(stride)
    n_seg = -(-n_sub // seg)
    key_seg = n_sub + 1 > GAP_BWD_BINS
    nbins = n_seg + 1 if key_seg else n_sub + 1
    smem = _gap_bwd_smem_bytes(d_h)
    if nbins > GAP_BWD_BINS or smem > SMEM_BYTES:
        return None
    chunk_rows = max(32, _round32(-(-R // blocks)))
    chunks = -(-R // chunk_rows)
    return GapBwdPlan(GAP_BWD_WPT, GAP_BWD_WARPS, *GAP_BWD_LONG, blocks, seg,
                      chunk_rows, chunks, nbins, key_seg, smem,
                      _gap_bwd_scratch_floats(K, R, d_h, seg, nbins,
                                              blocks, chunks))


# rows 2-3's launch plan (csrc/gap_train.cu, the forward): one cooperative
# launch of GAP_FWD_WARPS warps a block, the long rows (a key of at least
# GAP_BWD_LONG[0] / GAP_BWD_LONG[1] of the longest, rounded up, as the
# backward's) on a group of GAP_BWD_WPT warps, the rest one a warp; the
# sort's keys as the backward's (:func:`gap_fwd_key_div`); the grid
# GAP_FWD_BLOCKS_PER_SM blocks an SM (GAP_FWD_BLOCKS on an H100).  The H100
# A/B behind them: PERF.md section 6, row 3's design.
GAP_FWD_WARPS = 8
GAP_FWD_BLOCKS_PER_SM = 1
GAP_FWD_BLOCKS = 132


class GapFwdPlan(NamedTuple):
    """Rows 2-3's launch plan: warps a long row's group, warps a block,
    blocks, the sort's keys (nbins of them, a count's key the count over
    key_div, rounded up), the shared bytes and the scratch ints."""
    wpt: int
    warps: int
    blocks: int
    nbins: int
    key_div: int
    smem: int
    scratch: int

    def ints(self) -> list[int]:
        """The plan as njode_gap_train_fwd takes it."""
        return [self.blocks, self.nbins, self.key_div]


def gap_fwd_key_div(n_sub: int, stride: int) -> int:
    """The forward's sort key of a row is its substep count over this,
    rounded up: 1 up to GAP_BWD_BINS - 1 substeps, else the backward's
    segment (:func:`bwd_segment`), so that the two kernels' orders are one,
    times the least whole factor that keeps the keys within GAP_BWD_BINS
    (csrc/gap_train.cu's ``fwd_key_div``)."""
    if n_sub + 1 <= GAP_BWD_BINS:
        return 1
    seg = bwd_segment(stride)
    n_seg = -(-n_sub // seg)
    return seg * -(-n_seg // (GAP_BWD_BINS - 1))


def _gap_fwd_smem_bytes(d_h: int) -> int:
    """csrc/gap_train.cu's ``fwd_smem_bytes``: the W1h and W2 planes (HP x
    (HP + 1)), the two groups' partial-product buffers, each warp's vector
    (HP floats) of a single-warp product, the sort's keys (GAP_BWD_BINS)
    and 32 words."""
    hp = _plane_rows(d_h)
    return 4 * (2 * hp * (hp + 1)
                + GAP_FWD_WARPS // GAP_BWD_WPT * 2 * GAP_BWD_WPT * hp
                + GAP_FWD_WARPS * hp + GAP_BWD_BINS + 32)


def _gap_fwd_scratch_ints(K: int, R: int, nbins: int, blocks: int) -> int:
    """csrc/gap_train.cu's ``fwd_layout``: the sort's counts, sorted rows and
    their counts, the keys' per-block counts and totals, each part a whole
    number of 32 ints, then two counters a network."""
    return (3 * _round32(R) + _round32(blocks * nbins) + _round32(nbins)
            + _round32(2 * K))


@functools.lru_cache(maxsize=None)
def gap_fwd_plan(d_h: int, R: int, n_sub: int, stride: int, K: int = 1,
                 blocks: int = GAP_FWD_BLOCKS) -> GapFwdPlan | None:
    """Rows 2-3's launch plan for K networks of R rows of width d_h, n_sub
    substeps stored every ``stride``, on a grid of ``blocks`` (the card's
    resident blocks; the kernel checks them), or None where the kernel does
    not take the shape."""
    d_h, R, n_sub, stride, K, blocks = (int(d_h), int(R), int(n_sub),
                                        int(stride), int(K), int(blocks))
    if not (1 <= d_h <= MAX_HIDDEN and R >= 1 and n_sub >= 1
            and 1 <= stride <= MAX_STRIDE and 1 <= K <= blocks
            <= GAP_BWD_MAX_BLOCKS):
        return None
    key_div = gap_fwd_key_div(n_sub, stride)
    nbins = -(-n_sub // key_div) + 1
    smem = _gap_fwd_smem_bytes(d_h)
    if nbins > GAP_BWD_BINS or smem > SMEM_BYTES:
        return None
    return GapFwdPlan(GAP_BWD_WPT, GAP_FWD_WARPS, blocks, nbins, key_div,
                      smem, _gap_fwd_scratch_ints(K, R, nbins, blocks))


def gap_fwd_order(counts, n_sub: int, stride: int):
    """The forward's row order and its long rows (device sort): longest
    first by the key (:func:`gap_fwd_key_div`), rows of one key in row
    order; the long rows, those whose key is at least ceil(longest key *
    GAP_BWD_LONG[0] / GAP_BWD_LONG[1]) (at least 1), are the order's first
    n_long.  Returns (order, n_long)."""
    key_div = gap_fwd_key_div(n_sub, stride)
    key = -(-counts // key_div)
    order = torch.sort(-key, stable=True).indices
    top = int(key.max())
    num, den = GAP_BWD_LONG
    thr = max(-(-top * num // den), 1)
    return order, (int((key >= thr).sum()) if top > 0 else 0)


def use_remat(n_sub: int) -> bool:
    """Whether the training pair checkpoints (``_use_remat``)."""
    return n_sub > 2 * CK


def residual_stride(n_sub: int) -> int:
    """Substeps between stored states: 1 (rows 2 and 4) or CK (rows 3, 5)."""
    return CK if use_remat(n_sub) else 1


def gap_train_fits(d_h: int) -> bool:
    """Whether the training kernels take this width (d_h <= MAX_HIDDEN; the
    backward's shared memory then fits at either residual stride, which
    :func:`gap_bwd_plan` mirrors and csrc/gap_train.cu checks on the
    card)."""
    return 1 <= d_h <= MAX_HIDDEN


def gap_scan_available(n_hidden_layers: int, activation: str,
                       dropout_rate: float, input_scaling: str) -> bool:
    """Whether the kernel computes this ODEFunc (canonical names expected)."""
    return (n_hidden_layers == 1 and dropout_rate == 0.0
            and activation in SUPPORTED_ACTS and input_scaling in _SCALE)


# --------------------------------------------------------------------------
# the full-step loop: kernel and plain version
# --------------------------------------------------------------------------

def gap_substeps_reference(h, base, t_last, t_target, w1h, w1t, w2, b2,
                           dt: float, n_sub: int, act_name: str,
                           scale_name: str):
    """Plain PyTorch version of the kernel: the full predicated substeps.

    h, base: (K, R, d_h); t_last, t_target: (R,); w1h, w2: (K, d_h, d_h) in
    (in, out) orientation, as :class:`GapWeights` holds them; w1t, b2:
    (K, d_h).  Returns (h_L, t_L).
    """
    act, scale = _ACT[act_name], _SCALE[scale_name]
    w1t_row, b2_row = w1t[:, None, :], b2[:, None, :]
    t = t_last
    for _ in range(n_sub):
        pred = (t + dt) < t_target
        pre = torch.matmul(scale(h), w1h) + base + t[None, :, None] * w1t_row
        dh = torch.matmul(act(pre), w2) + b2_row
        h = torch.where(pred[None, :, None], h + dt * dh, h)
        t = torch.where(pred, t + dt, t)
    return h, t


def gap_train_forward_reference(h, base, t_last, t_target, w1h, w1t, w2, b2,
                                dt: float, n_sub: int, stride: int,
                                act_name: str, scale_name: str):
    """Plain PyTorch version of the training forward (rows 2-3): the full
    predicated substeps of :func:`gap_substeps_reference`, storing the state
    entering every ``stride``-th substep.  Returns (h_L, t_L, res_h
    (n_res, K, R, d_h), res_t (n_res, R)), n_res = ceil(n_sub / stride)."""
    act, scale = _ACT[act_name], _SCALE[scale_name]
    w1t_row, b2_row = w1t[:, None, :], b2[:, None, :]
    t = t_last
    res_h, res_t = [], []
    for j in range(n_sub):
        if j % stride == 0:
            res_h.append(h)
            res_t.append(t)
        pred = (t + dt) < t_target
        pre = torch.matmul(scale(h), w1h) + base + t[None, :, None] * w1t_row
        dh = torch.matmul(act(pre), w2) + b2_row
        h = torch.where(pred[None, :, None], h + dt * dh, h)
        t = torch.where(pred, t + dt, t)
    return h, t, torch.stack(res_h), torch.stack(res_t)


def gap_train_backward_reference(g_h, base, t_target, w1h, w1t, w2, b2,
                                 res_h, res_t, dt: float, n_sub: int,
                                 stride: int, act_name: str,
                                 scale_name: str):
    """Plain PyTorch version of the backward (rows 4-5): the substeps in
    reverse, each stride-long segment first recomputed from its checkpoint,
    with the algebra of ``_bwd_kernel`` (njode_tpu/ops/gap_scan.py:422-517).
    Returns (gh0, gpre_sum, acc_t, gdh_sum), each (K, R, d_h), and (dW1h,
    dW2), each (K, d_h, d_h) as (in, out)."""
    act, dact = _ACT[act_name], _ACT_GRAD[act_name]
    scale, dscale = _SCALE[scale_name], _SCALE_GRAD[scale_name]
    w1t_row, b2_row = w1t[:, None, :], b2[:, None, :]
    w1h_t, w2_t = w1h.transpose(1, 2), w2.transpose(1, 2)
    gh = g_h
    gpre_sum, acc_t, gdh_sum = (torch.zeros_like(g_h) for _ in range(3))
    dw1h, dw2 = torch.zeros_like(w1h), torch.zeros_like(w2)

    def pre_of(h, t):
        return torch.matmul(scale(h), w1h) + base + t[None, :, None] * w1t_row
    for s in reversed(range(res_t.shape[0])):
        h, t = res_h[s], res_t[s]
        states = []
        for c in range(min(stride, n_sub - s * stride)):
            if c:
                pred = (t + dt) < t_target
                dh = torch.matmul(act(pre_of(h, t)), w2) + b2_row
                h = torch.where(pred[None, :, None], h + dt * dh, h)
                t = torch.where(pred, t + dt, t)
            states.append((h, t))
        for h_j, t_j in reversed(states):
            pred = ((t_j + dt) < t_target)[None, :, None]
            pre = pre_of(h_j, t_j)
            g_dh = torch.where(pred, dt * gh, 0.0)
            g_pre = torch.matmul(g_dh, w2_t) * dact(pre)
            dw2 = dw2 + torch.matmul(act(pre).transpose(1, 2), g_dh)
            dw1h = dw1h + torch.matmul(scale(h_j).transpose(1, 2), g_pre)
            gpre_sum = gpre_sum + g_pre
            acc_t = acc_t + t_j[None, :, None] * g_pre
            gdh_sum = gdh_sum + g_dh
            gh = gh + torch.matmul(g_pre, w1h_t) * dscale(h_j)
    return gh, gpre_sum, acc_t, gdh_sum, dw1h, dw2


def gap_substep_counts(t_last, t_target, dt: float, n_sub: int):
    """Each row's taken substeps by the loop's own float sequence (t + dt <
    t_target, t += dt) from t_last, as the backward counts them on the
    device: (counts (R,) int64, t_L (R,), bitwise the forward's)."""
    t = t_last.clone()
    counts = torch.zeros(t.shape, dtype=torch.int64, device=t.device)
    for _ in range(n_sub):
        pred = (t + dt) < t_target
        t = torch.where(pred, t + dt, t)
        counts += pred
    return counts, t


def gap_bwd_order(counts, n_sub: int, seg: int):
    """The backward's row order: longest first by the sort key (the count,
    or past GAP_BWD_BINS - 1 substeps the count of segments of ``seg``
    substeps), rows of one key in row order (a stable sort)."""
    key = counts if n_sub + 1 <= GAP_BWD_BINS else -(-counts // seg)
    return torch.sort(-key, stable=True).indices


def gap_bwd_records_reference(g_h, base, t_target, w1h, w1t, w2, b2, res_h,
                              res_t, dt: float, n_sub: int, stride: int,
                              act_name: str, scale_name: str,
                              chunk_rows: int | None = None):
    """Plain PyTorch version of the backward (rows 4-5) with the kernel's
    data flow: each row's substeps counted by the float sequence, the rows
    sorted longest first (:func:`gap_bwd_order`), then segments of
    :func:`bwd_segment` substeps from the top down, each active row (a
    prefix of the sorted rows) rebuilding its segment's states (the stored
    ones loaded, the others recomputed) and walking it in reverse, writing
    the records s(h), g_pre, act(pre) and g_dh of every substep of the segment
    (zeros where it takes none); each segment's records summed by chunks of
    ``chunk_rows`` sorted rows (:func:`gap_bwd_plan`'s by default), a
    chunk's sum added to its accumulator segment by segment, the
    accumulators added in chunk order.  Same arguments and result as
    :func:`gap_train_backward_reference`."""
    act, dact = _ACT[act_name], _ACT_GRAD[act_name]
    scale, dscale = _SCALE[scale_name], _SCALE_GRAD[scale_name]
    K, R, d = g_h.shape
    seg = bwd_segment(stride)
    if chunk_rows is None:
        chunk_rows = gap_bwd_plan(d, R, n_sub, stride, K).chunk_rows
    counts, _ = gap_substep_counts(res_t[0], t_target, dt, n_sub)
    order = gap_bwd_order(counts, n_sub, seg)
    cs = counts[order]
    w1h_t, w2_t = w1h.transpose(1, 2), w2.transpose(1, 2)
    gh, gps, ats, gds = (x[:, order].clone() for x in (
        g_h, torch.zeros_like(g_h), torch.zeros_like(g_h),
        torch.zeros_like(g_h)))
    base_s = base[:, order]
    acc = {}
    for s in reversed(range(-(-n_sub // seg))):
        na = int((cs > s * seg).sum())
        if na == 0:
            continue
        n_c = min(seg, n_sub - s * seg)
        rows = order[:na]
        n_t = torch.clamp(cs[:na] - s * seg, max=n_c)
        states = []
        for c in range(n_c):
            j = s * seg + c
            if j % stride == 0:          # stored; the others recomputed
                h, t = res_h[j // stride][:, rows], res_t[j // stride][rows]
            pre = (torch.matmul(scale(h), w1h) + base_s[:, :na]
                   + t[None, :, None] * w1t[:, None])
            states.append((h, pre, t))
            take = (c + 1 < n_t)[None, :, None]
            h = torch.where(take, h + dt * (torch.matmul(act(pre), w2)
                                            + b2[:, None]), h)
            t = torch.where(take[0, :, 0], t + dt, t)
        recs = [None] * n_c
        for c in reversed(range(n_c)):
            h, pre, t = states[c]
            m = (c < n_t)[None, :, None]
            g_dh = torch.where(m, dt * gh[:, :na], 0.0)
            g_pre = torch.matmul(g_dh, w2_t) * dact(pre)
            gh[:, :na] = gh[:, :na] + torch.where(
                m, torch.matmul(g_pre, w1h_t) * dscale(h), 0.0)
            gps[:, :na] += g_pre
            ats[:, :na] += t[None, :, None] * g_pre
            gds[:, :na] += g_dh
            recs[c] = (torch.where(m, scale(h), 0.0), g_pre,
                       torch.where(m, act(pre), 0.0), g_dh)
        sh, gp, hid, gdh = (torch.stack([r[i] for r in recs], 1)
                            for i in range(4))          # (K, n_c, na, d)
        for j, p0 in enumerate(range(0, na, chunk_rows)):
            sl = slice(p0, p0 + chunk_rows)

            def flat(x):
                return x[:, :, sl].reshape(K, -1, d)
            part = torch.stack([
                torch.matmul(flat(sh).transpose(1, 2), flat(gp)),
                torch.matmul(flat(hid).transpose(1, 2), flat(gdh))], 1)
            acc[j] = part if j not in acc else acc[j] + part
    dw = torch.zeros(K, 2, d, d, dtype=g_h.dtype, device=g_h.device)
    for j in sorted(acc):
        dw = dw + acc[j]
    inv = torch.argsort(order)
    return (gh[:, inv], gps[:, inv], ats[:, inv], gds[:, inv], dw[:, 0],
            dw[:, 1])


@functools.cache
def _load_kernel():
    """Build (first call only) and bind ``njode_gap_scan_fwd``."""
    from ._build import load
    lib = load("gap_scan")
    fn = lib.njode_gap_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _load_train_kernel():
    """Build (first call only) and bind the training pair of gap_train.cu."""
    from ._build import load
    lib = load("gap_train")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.njode_gap_train_fwd.argtypes = ([P] * 13 + [ctypes.c_longlong]
                                        + [I] * 3 + [F] + [I] * 4
                                        + [ctypes.POINTER(I), P])
    lib.njode_gap_train_fwd.restype = I
    lib.njode_gap_train_fwd_grid.argtypes = [I, ctypes.POINTER(I)]
    lib.njode_gap_train_fwd_grid.restype = I
    lib.njode_gap_train_bwd_grid.argtypes = [I, ctypes.POINTER(I)]
    lib.njode_gap_train_bwd_grid.restype = I
    lib.njode_gap_train_bwd.argtypes = ([P] * 15 + [ctypes.c_longlong]
                                        + [I] * 3 + [F] + [I] * 4
                                        + [ctypes.POINTER(I), P])
    lib.njode_gap_train_bwd.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _plan_arg(plan: GapPlan | GapFwdPlan):
    """The plan as the C array its kernel's entry reads (one a plan)."""
    ints = plan.ints()
    return (ctypes.c_int * len(ints))(*ints)


def _check_cuda_inputs(named: dict[str, torch.Tensor],
                       shapes: dict[str, tuple],
                       what: str = "gap_substeps") -> torch.device:
    device = named["h"].device
    for name, x in named.items():
        if x.device != device:
            raise ValueError(f"{what}: {name} is on {x.device}, h on "
                             f"{device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: the CUDA kernel takes float32, "
                            f"{name} is {x.dtype}")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(x.shape)}, expected {shapes[name]}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return device


def _check_call(tensors: dict[str, torch.Tensor], act_name: str,
                scale_name: str, what: str) -> torch.device:
    """The kernels' common checks; the device of h (cuda)."""
    if tensors["h"].device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device "
                         f"{tensors['h'].device} (or tensors on mixed "
                         "devices)")
    if act_name not in SUPPORTED_ACTS or scale_name not in _SCALE:
        raise ValueError(f"{what}: unsupported activation/scaling "
                         f"{act_name!r}/{scale_name!r}")
    K, R, d_h = tensors["h"].shape
    mat, vec, row = (K, d_h, d_h), (K, d_h), (R,)
    shapes = {"h": (K, R, d_h), "base": (K, R, d_h), "t_last": row,
              "t_target": row, "w1h": mat, "w1t": vec, "w2": mat, "b2": vec}
    return _check_cuda_inputs(tensors, {n: shapes[n] for n in tensors}, what)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def gap_substeps(h, base, t_last, t_target, w1h, w1t, w2, b2,
                 dt: float, n_sub: int, act_name: str, scale_name: str):
    """The full-step loop: for CUDA tensors the primal-only kernel, or,
    when autograd wants a gradient of any of h, base or the weights, the
    training pair through :class:`GapScan`; the plain versions for CPU
    tensors; an error for anything else.  Same arguments and result as
    :func:`gap_substeps_reference`."""
    global LAUNCHES
    if n_sub < 0 or not dt > 0.0:
        raise ValueError(f"gap_substeps: need n_sub >= 0 and dt > 0, got "
                         f"{n_sub}, {dt}")
    if n_sub == 0:
        return h, t_last
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (h, base, w1h, w1t, w2, b2)):
        return GapScan.apply(h, base, w1h, w1t, w2, b2, t_last, t_target,
                             float(dt), int(n_sub), act_name, scale_name)
    tensors = {"h": h, "base": base, "t_last": t_last, "t_target": t_target,
               "w1h": w1h, "w1t": w1t, "w2": w2, "b2": b2}
    if all(x.device.type == "cpu" for x in tensors.values()):
        return gap_substeps_reference(h, base, t_last, t_target, w1h, w1t,
                                      w2, b2, dt, n_sub, act_name, scale_name)
    device = _check_call(tensors, act_name, scale_name, "gap_substeps")
    K, R, d_h = h.shape
    plan = gap_plan(d_h, scale_name)
    if plan is None:
        raise ValueError(f"gap_substeps: no launch plan fits d_h {d_h}")
    lib, fn = _load_kernel()
    h_out = torch.empty_like(h)
    t_out = torch.empty_like(t_last)
    with torch.cuda.device(device):
        err = fn(h.data_ptr(), base.data_ptr(), t_last.data_ptr(),
                 t_target.data_ptr(), w1h.data_ptr(), w1t.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), h_out.data_ptr(),
                 t_out.data_ptr(), K, R, d_h, float(dt), int(n_sub),
                 SUPPORTED_ACTS.index(act_name), SCALINGS.index(scale_name),
                 _plan_arg(plan), plan.smem,
                 _stream(device))
    from ._build import check
    check(lib, err, "njode_gap_scan_fwd launch")
    LAUNCHES += 1
    return h_out, t_out


# --------------------------------------------------------------------------
# the training pair: kernels, their launchers and the autograd Function
# --------------------------------------------------------------------------

def _mode(stride: int) -> str:
    return "full" if stride == 1 else "checkpointed"


@functools.lru_cache(maxsize=None)
def _fwd_blocks(device_index: int, d_h: int) -> int:
    """The forward's grid on this card (njode_gap_train_fwd_grid:
    GAP_FWD_BLOCKS_PER_SM blocks an SM where its instances' occupancy for
    d_h allows); one query a card and width."""
    lib = _load_train_kernel()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.njode_gap_train_fwd_grid(int(d_h), ctypes.byref(blocks))
    from ._build import check
    check(lib, err, "njode_gap_train_fwd_grid")
    return min(blocks.value, GAP_BWD_MAX_BLOCKS)


def _launch_train_fwd(h, base, t_last, t_target, w1h, w1t, w2, b2,
                      dt: float, n_sub: int, stride: int, act_name: str,
                      scale_name: str):
    """The forward kernel (row 2 at stride 1, row 3 beyond): (h_L, t_L,
    res_h, res_t) as :func:`gap_train_forward_reference` returns them."""
    tensors = {"h": h, "base": base, "t_last": t_last, "t_target": t_target,
               "w1h": w1h, "w1t": w1t, "w2": w2, "b2": b2}
    device = _check_call(tensors, act_name, scale_name, "gap_train_forward")
    K, R, d_h = h.shape
    if n_sub < 1 or not 1 <= d_h <= MAX_HIDDEN:
        raise ValueError(f"gap_train_forward: need n_sub >= 1 and 1 <= d_h "
                         f"<= {MAX_HIDDEN}, got {n_sub}, {d_h}")
    n_res = -(-n_sub // stride)
    lib = _load_train_kernel()
    plan = gap_fwd_plan(d_h, R, int(n_sub), int(stride), K,
                        _fwd_blocks(device.index or 0, d_h))
    if plan is None:
        raise ValueError(f"gap_train_forward: no launch plan fits d_h {d_h},"
                         f" {K} networks, n_sub {n_sub}, stride {stride}")
    h_out, t_out = torch.empty_like(h), torch.empty_like(t_last)
    res_h = torch.empty(n_res, K, R, d_h, dtype=h.dtype, device=device)
    res_t = torch.empty(n_res, R, dtype=h.dtype, device=device)
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.njode_gap_train_fwd(
            h.data_ptr(), base.data_ptr(), t_last.data_ptr(),
            t_target.data_ptr(), w1h.data_ptr(), w1t.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), h_out.data_ptr(), t_out.data_ptr(),
            res_h.data_ptr(), res_t.data_ptr(), scratch.data_ptr(),
            plan.scratch, K, R, d_h, float(dt), int(n_sub), int(stride),
            SUPPORTED_ACTS.index(act_name), SCALINGS.index(scale_name),
            _plan_arg(plan), _stream(device))
    from ._build import check
    check(lib, err, "njode_gap_train_fwd launch")
    LAUNCHES_RES_FWD[_mode(stride)] += 1
    return h_out, t_out, res_h, res_t


@functools.lru_cache(maxsize=None)
def _bwd_launch(device_index: int, d_h: int, R: int, n_sub: int, stride: int,
                K: int):
    """The backward's plan on this card (its grid from
    njode_gap_train_bwd_grid: resident blocks by the occupancy of the
    instances for d_h) and the plan as the C array the kernel reads; one
    query a card and shape."""
    lib = _load_train_kernel()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.njode_gap_train_bwd_grid(int(d_h), ctypes.byref(blocks))
    from ._build import check
    check(lib, err, "njode_gap_train_bwd_grid")
    plan = gap_bwd_plan(d_h, R, n_sub, stride, K,
                        min(blocks.value, GAP_BWD_MAX_BLOCKS))
    if plan is None:
        raise ValueError(f"gap_train_backward: no launch plan fits d_h {d_h},"
                         f" {K} networks, n_sub {n_sub}, stride {stride}")
    return plan, (ctypes.c_int * 4)(*plan.ints())


def _launch_train_bwd(g_h, base, t_target, w1h, w1t, w2, b2, res_h, res_t,
                      dt: float, n_sub: int, stride: int, act_name: str,
                      scale_name: str):
    """The backward kernel (row 4 at stride 1, row 5 beyond), one
    cooperative launch with its weight sums: what
    :func:`gap_train_backward_reference` returns."""
    tensors = {"h": g_h, "base": base, "t_target": t_target, "w1h": w1h,
               "w1t": w1t, "w2": w2, "b2": b2}
    device = _check_call(tensors, act_name, scale_name, "gap_train_backward")
    K, R, d_h = g_h.shape
    n_res = -(-n_sub // stride)
    if (tuple(res_h.shape) != (n_res, K, R, d_h)
            or tuple(res_t.shape) != (n_res, R)
            or not (res_h.is_contiguous() and res_t.is_contiguous())):
        raise ValueError(f"gap_train_backward: residuals {tuple(res_h.shape)}"
                         f" / {tuple(res_t.shape)} do not fit n_sub {n_sub},"
                         f" stride {stride}")
    lib = _load_train_kernel()
    from ._build import check
    plan, plan_arg = _bwd_launch(device.index or 0, d_h, R, int(n_sub),
                                 int(stride), K)
    # the four row outputs, dw and the scratch in one allocation
    n = K * R * d_h
    buf = torch.empty(4 * n + 2 * K * d_h * d_h + plan.scratch,
                      dtype=torch.float32, device=device)
    outs = [buf[i * n:(i + 1) * n].view(K, R, d_h) for i in range(4)]
    dw = buf[4 * n:4 * n + 2 * K * d_h * d_h].view(K, 2, d_h, d_h)
    scratch = buf[4 * n + 2 * K * d_h * d_h:]
    with torch.cuda.device(device):
        err = lib.njode_gap_train_bwd(
            g_h.data_ptr(), base.data_ptr(), t_target.data_ptr(),
            w1h.data_ptr(), w1t.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            res_h.data_ptr(), res_t.data_ptr(),
            *(x.data_ptr() for x in outs), dw.data_ptr(), scratch.data_ptr(),
            plan.scratch, K, R, d_h, float(dt), int(n_sub), int(stride),
            SUPPORTED_ACTS.index(act_name), SCALINGS.index(scale_name),
            plan_arg, _stream(device))
    check(lib, err, "njode_gap_train_bwd launch")
    LAUNCHES_BWD[_mode(stride)] += 1
    return (*outs, dw[:, 0], dw[:, 1])


class GapScan(torch.autograd.Function):
    """The training pair as one differentiable op: (h, base, w1h, w1t, w2,
    b2, t_last, t_target) -> (h_L, t_L), t_L not differentiable (times are
    data).  ``n_sub >= 1``; the residual stride is :func:`residual_stride`.
    The kernels run for CUDA tensors, their plain versions for CPU tensors
    (all inputs on the CPU; anything else goes to the kernels' checks).
    """

    @staticmethod
    def forward(ctx, h, base, w1h, w1t, w2, b2, t_last, t_target, dt, n_sub,
                act_name, scale_name):
        stride = residual_stride(n_sub)
        args = [x.contiguous() for x in (h, base, t_last, t_target, w1h,
                                         w1t, w2, b2)]
        on_cpu = all(x.device.type == "cpu" for x in args)
        if not on_cpu and not gap_train_fits(h.shape[-1]):
            raise ValueError(f"GapScan: d_h {h.shape[-1]} is beyond the "
                             "training kernels (gap_train_fits)")
        fwd = gap_train_forward_reference if on_cpu else _launch_train_fwd
        h_l, t_l, res_h, res_t = fwd(*args, dt, n_sub, stride, act_name,
                                     scale_name)
        _, base_c, _, t_tgt, w1h_c, w1t_c, w2_c, b2_c = args
        ctx.save_for_backward(base_c, t_tgt, w1h_c, w1t_c, w2_c, b2_c,
                              res_h, res_t)
        ctx.meta = (dt, n_sub, stride, act_name, scale_name, on_cpu)
        ctx.mark_non_differentiable(t_l)
        return h_l, t_l

    @staticmethod
    def backward(ctx, g_h, _g_t):
        base, t_tgt, w1h, w1t, w2, b2, res_h, res_t = ctx.saved_tensors
        dt, n_sub, stride, act_name, scale_name, on_cpu = ctx.meta
        bwd = gap_train_backward_reference if on_cpu else _launch_train_bwd
        gh0, gpre_sum, acc_t, gdh_sum, dw1h, dw2 = bwd(
            g_h.contiguous(), base, t_tgt, w1h, w1t, w2, b2, res_h, res_t,
            dt, n_sub, stride, act_name, scale_name)
        return (gh0, gpre_sum, dw1h, acc_t.sum(1), dw2, gdh_sum.sum(1),
                None, None, None, None, None, None)


# --------------------------------------------------------------------------
# the whole gap: weights, hoisted base, full steps, final partial step
# --------------------------------------------------------------------------

class GapWeights(NamedTuple):
    """The ODEFunc weights stacked on K_h, matrices in (in, out)
    orientation, all contiguous.

    w1: (K_h, d_h+d_x+2, d_h), rows [h, x, t_rel, t_elapsed]; b1: (K_h, d_h);
    w2: (K_h, d_h, d_h); b2: (K_h, d_h); and apart, as the kernel reads
    them, W1's h rows w1h: (K_h, d_h, d_h) and t_rel row w1t: (K_h, d_h).
    """
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w1h: torch.Tensor
    w1t: torch.Tensor


def split_weights(ode_weights: Sequence[torch.Tensor]) -> GapWeights:
    """:class:`GapWeights` from (W1, b1, W2, b2), stacked on K_h in torch's
    (out, in) orientation: (K_h, d_h, d_h+d_x+2), (K_h, d_h), (K_h, d_h, d_h),
    (K_h, d_h)."""
    w1, b1, w2, b2 = ode_weights
    d_h = w2.shape[-1]
    d_x = w1.shape[-1] - d_h - 2
    if d_x < 0 or w1.shape[:2] != w2.shape[:2]:
        raise ValueError(f"ODEFunc W1 {tuple(w1.shape)} does not fit W2 "
                         f"{tuple(w2.shape)}: expected (K, d_h, d_h+d_x+2)")
    w1_io = w1.transpose(1, 2).contiguous()
    return GapWeights(w1_io, b1.contiguous(), w2.transpose(1, 2).contiguous(),
                      b2.contiguous(), w1_io[:, :d_h].contiguous(),
                      w1_io[:, d_h + d_x].contiguous())


def substep_inputs(h, x_scaled, t_last, t_target, w: GapWeights,
                   dt_ode_step: float):
    """Hoist the part of the pre-activation constant across full substeps,
    base = s(x) W1x + dt w1dt + b1 (x and the full-step t_elapsed = dt are
    fixed within a gap): the first eight arguments of :func:`gap_substeps`,
    contiguous."""
    K, R, d_h = h.shape
    d_x = x_scaled.shape[-1]
    if w.w1.shape != (K, d_h + d_x + 2, d_h):
        raise ValueError(f"ODEFunc W1 has shape {tuple(w.w1.shape)}, expected "
                         f"{(K, d_h + d_x + 2, d_h)}")
    b = torch.add(w.b1, w.w1[:, -1], alpha=float(dt_ode_step))[:, None]
    base = torch.baddbmm(b, x_scaled.expand(K, R, d_x),
                         w.w1[:, d_h:d_h + d_x])
    return (h.contiguous(), base, t_last.contiguous(), t_target.contiguous(),
            w.w1h, w.w1t, w.w2, w.b2)


def _integrate(substeps, h, x_scaled, t_last, t_target, w: GapWeights,
               dt_ode_step: float, max_substeps: int, act_name: str,
               scale_name: str):
    K, R, d_x = h.shape[0], h.shape[1], x_scaled.shape[-1]
    act, scale = _ACT[act_name], _SCALE[scale_name]
    h_l, t_l = substeps(*substep_inputs(h, x_scaled, t_last, t_target, w,
                                        dt_ode_step),
                        float(dt_ode_step), int(max_substeps), act_name,
                        scale_name)
    # final partial step to exactly t_target (reference :201-202), features
    # [s(h), s(x), t_rel = t_L, t_elapsed = t_target - t_L]
    t_el = t_target - t_l
    inp = torch.cat([scale(h_l), x_scaled.expand(K, R, d_x),
                     t_l[None, :, None].expand(K, R, 1),
                     t_el[None, :, None].expand(K, R, 1)], dim=-1)
    pre = torch.baddbmm(w.b1[:, None], inp, w.w1)
    dh = torch.baddbmm(w.b2[:, None], act(pre), w.w2)
    h_fin = torch.addcmul(h_l, t_el[None, :, None], dh)
    return torch.where((t_l < t_target)[None, :, None], h_fin, h_l), t_l


def integrate_gap_fused(h, x_scaled, t_last, t_target, weights: GapWeights,
                        dt_ode_step: float, max_substeps: int,
                        act_name: str, scale_name: str):
    """Whole-gap integration for all K_h moment networks, full steps in the
    CUDA kernel (its plain version on the CPU).

    Args:
      h:        (K_h, R, d_h) jump states (one gap per row).
      x_scaled: (R, d_x) input-scaled last observations.
      t_last, t_target: (R,) gap boundaries.
      weights:  the ODEFunc's :class:`GapWeights` (see :func:`split_weights`).

    Returns: ((K_h, R, d_h) latent states at t_target, (R,) t_L, the time
      the full steps reached).
    """
    return _integrate(gap_substeps, h, x_scaled, t_last, t_target, weights,
                      dt_ode_step, max_substeps, act_name, scale_name)


def integrate_gap_reference(h, x_scaled, t_last, t_target,
                            weights: GapWeights, dt_ode_step: float,
                            max_substeps: int, act_name: str,
                            scale_name: str):
    """Plain PyTorch version of :func:`integrate_gap_fused` on any device."""
    return _integrate(gap_substeps_reference, h, x_scaled, t_last, t_target,
                      weights, dt_ode_step, max_substeps, act_name,
                      scale_name)
