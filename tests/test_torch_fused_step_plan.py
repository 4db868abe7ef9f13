"""The fused step's launch plans and shape gate
(njode_tpu_torch/ops/fused_step.py): the f32 instances' tiles and slot
groups (``f32_plan``, mirroring csrc/step_f32.cuh's ``smem_floats``), and
``fused_step_fits``, which must admit every shape the slot-serial f32
kernels admitted: the gate below is theirs, frozen (8 warps of RPW rows,
RPW 8 forward and 4 or 2 backward, 3 L + 3 activation buffers)."""

import itertools

import pytest

from njode_tpu_torch.ops import fused_step as fs

SMEM = 232_448


def slot_serial_fits(H, N, L, d_x, d_y, K):
    """The shape gate of the slot-serial kernels, frozen."""
    if not (1 <= H <= 256 and N >= 1 and L >= 1 and d_x >= 1 and d_y >= 1
            and K >= 1):
        return False
    HS = -(-H // 32) * 32 + 8
    stage = 8 * 3 * 8 * 32
    scal = lambda rt: rt * N * (2 * d_x + 1)           # noqa: E731
    fwd = stage + 2 * 64 * HS + scal(64)
    bwd = [stage + (3 * L + 3) * rt * HS + scal(rt) + rt * (2 * N - 1) * d_y * K
           for rt in (32, 16)]
    return 4 * fwd <= SMEM and min(bwd) * 4 <= SMEM


def test_f32_plan_at_the_scaled_shape():
    """H 256, N 2, L 1, two networks: 64 trajectories a tile and both
    slots in one group (128 blocks, one an SM), within the shared memory."""
    plan = fs.f32_plan(256, 2, 1, 1, 1, 2)
    assert plan == ((64, 2), (64, 2))
    for backward, (rt, sg) in zip((False, True), plan):
        floats = fs._f32_smem_floats(backward, rt, sg, 256, 2, 1, 1, 2)
        assert 4 * floats <= fs.SMEM_BYTES
    assert fs.kernel_plan(256, 2, 1, 1, 1, 2, bf16=True) == ((64, 2), (32, 2))
    assert fs.kernel_plan(256, 2, 1, 1, 1, 2, bf16=False) == plan


@pytest.mark.parametrize("H,N,L,shared", list(itertools.product(
    (32, 50, 256), (1, 2, 10), (1, 2), (False, True))))
def test_f32_plan_on_the_card_checks_grid(H, N, L, shared):
    """chip_smoke.py's grid of rows 9-10: a plan within the shared memory,
    a tile of 64, 32 or 16 trajectories and the most slots a group that
    fit."""
    K = 2
    plan = fs.f32_plan(H, N, L, 1, 1, K)
    assert plan is not None and fs.fused_step_fits(H, N, L, 1, 1, K)
    for backward, (rt, sg) in zip((False, True), plan):
        assert rt in fs.F32_ROWS and 1 <= sg <= N
        assert 4 * fs._f32_smem_floats(backward, rt, sg, H, N, 1, 1,
                                        K) <= fs.SMEM_BYTES
        if sg < N:
            assert 4 * fs._f32_smem_floats(backward, rt, sg + 1, H, N, 1, 1,
                                            K) > fs.SMEM_BYTES


@pytest.mark.parametrize("H", (1, 7, 16, 32, 50, 64, 100, 128, 200, 255,
                               256))
def test_fits_admits_every_slot_serial_shape(H):
    """Wherever the slot-serial kernels had a plan, both instances have
    one now (the f32 plan on its own too), and nowhere else."""
    for N, L, d_x, d_y, K in itertools.product(
            (1, 2, 3, 5, 10, 11, 12, 20, 50, 94, 95, 150),
            (1, 2, 3, 4), (1, 2, 7, 30), (1, 3), (1, 2, 5)):
        old = slot_serial_fits(H, N, L, d_x, d_y, K)
        assert fs.fused_step_fits(H, N, L, d_x, d_y, K) == old, (
            H, N, L, d_x, d_y, K)
        if old:
            assert fs.f32_plan(H, N, L, d_x, d_y, K) is not None


def test_f32_smem_mirrors_the_source():
    """_f32_smem_floats against step_f32.cuh's smem_floats, written out:
    80 floats of barriers and block constants, the stage of 3 x 8 rows of
    H padded to 16, the buffer of the group's rows (+ 4) per padded
    feature, x, s(x), t and (backward) gy."""
    H, N, rt, sg, d_x, d_y, K = 50, 10, 16, 3, 2, 3, 2
    Hp = 64
    fwd = 80 + 3 * 8 * Hp + Hp * (2 * sg * rt + 4) + rt * N * (2 * d_x + 1)
    assert fs._f32_smem_floats(False, rt, sg, H, N, d_x, d_y, K) == fwd
    assert fs._f32_smem_floats(True, rt, sg, H, N, d_x, d_y, K) == (
        fwd + rt * (2 * N - 1) * d_y * K)
    # one group of every slot: the buffer holds 2N - 1 slot rows
    assert fs._f32_smem_floats(False, rt, N, H, N, d_x, d_y, K) == (
        80 + 3 * 8 * Hp + Hp * ((2 * N - 1) * rt + 4) + rt * N * (2 * d_x + 1))
