"""The fused Euler cell's block shape (row 6, njode_tpu_torch/ops/csrc/
fused_cell.cu ``njode_fused_cell``) mirrored from its source.

A warp owns a tile of kRows rows, staged in shared memory; a block has
kWarps warps where their rows fit the H100's 227 KB of opt-in shared memory
and as many as fit wider.  The mirror below is the source's sum, checked
against its text, and holds that every width at which 16 rows of d_in + d
floats fit a block (the limit of the block-staged design this kernel
replaced) launches.  The kernel's
results at d_h 512 and 1,800 are held against the plain version on the card
(chip_smoke.py, ``CELL_SHAPES``).
"""

import re
from pathlib import Path

import pytest

from njode_tpu_torch.ops import fused_cell

SMEM = 232_448
SRC = (Path(fused_cell.__file__).parent / "csrc" / "fused_cell.cu").read_text()


def source_constant(name):
    return int(re.search(rf"\b{name} = (\d+)", SRC).group(1))


K_WARPS, K_ROWS, K_REG_IN = (source_constant(n)
                             for n in ("kWarps", "kRows", "kRegIn"))


def r4(x):
    return -(-x // 4) * 4


def warp_bytes(d_in, d):
    """``warp_floats`` in bytes: the input rows at stride kRegIn (register
    instance) or d_in, then the state, hidden, pre and out rows at stride
    32 or d, each part a whole number of float4s."""
    reg = d <= 32 and d_in <= K_REG_IN
    ldi, ldh = (K_REG_IN, 32) if reg else (d_in, d)
    return 4 * (r4(K_ROWS * ldi) + 4 * r4(K_ROWS * ldh))


def block_warps(d_in, d, smem=SMEM):
    """Warps a block (``njode_fused_cell``): kWarps, or as many as the
    shared memory holds; 0 where not one warp's rows fit."""
    return min(K_WARPS, smem // warp_bytes(d_in, d))


def test_cell_block_mirrors_the_source():
    """The constants and the sums the mirror copies, as the source has
    them."""
    assert (K_WARPS, K_ROWS, K_REG_IN) == (8, 4, 48)
    for line in (
            "return (kRows * in_stride(reg, d_in) + 3) / 4 * 4 + 4 * ((kRows "
            "* h_stride(reg, d) + 3) / 4 * 4);",
            "__host__ __device__ inline int in_stride(bool reg, int d_in) { "
            "return reg ? kRegIn : d_in; }",
            "__host__ __device__ inline int h_stride(bool reg, int d) { "
            "return reg ? kWarp : d; }",
            "const bool reg = d <= kWarp && d_in <= kRegIn;",
            "const long long fit = max_smem / warp_bytes;",
            "const int warps = fit < kWarps ? (int)fit : kWarps;",
            "const size_t smem = (size_t)warps * warp_bytes;",
            "const dim3 grid((tiles + warps - 1) / warps, K), "
            "block(kWarp, warps);",
            "for (int tile = blockIdx.x * blockDim.y + warp; tile < tiles; "
            "tile += gridDim.x * blockDim.y) {"):
        assert line in SRC, line


@pytest.mark.parametrize("d_x", [1, 2, 5, 16, 64])
def test_cell_takes_every_width_the_staged_kernel_took(d_x):
    """At d_in = d_h + d_x + 2 (the model's cell input), every width whose
    16 rows of d_in + d_h floats fit the shared memory (the block-staged
    design's limit) launches here: at least one warp's rows fit, and the
    block's shared bytes stay within the card's."""
    d = 1
    while 64 * (2 * d + d_x + 2) <= SMEM:
        d_in = d + d_x + 2
        w = block_warps(d_in, d)
        assert 1 <= w <= K_WARPS, (d, d_x)
        assert w * warp_bytes(d_in, d) <= SMEM
        d += 1
    assert d > 1700
    assert 64 * (2 * 1814 + 3) <= SMEM < 64 * (2 * 1815 + 3)


@pytest.mark.parametrize("d_h,warps", [(32, 8), (50, 8), (300, 8),
                                        (512, 5), (1800, 1)])
def test_cell_block_at_the_checked_shapes(d_h, warps):
    """chip_smoke.py's ``CELL_SHAPES`` (d_in = d_h + 3): the forced default
    shape on the register instance, a full block up to d_h 300, 5 warps at
    d_h 512 and one at 1,800, near the block-staged design's widest (1,814
    at this d_in)."""
    import chip_smoke
    assert d_h in {s[2] for s in chip_smoke.CELL_SHAPES}
    d_in = d_h + 3
    assert block_warps(d_in, d_h) == warps
    assert 64 * (d_in + d_h) <= SMEM        # the staged kernel took it
    if d_h == 32:
        assert warp_bytes(d_in, d_h) == 4 * (4 * 48 + 4 * 4 * 32)
