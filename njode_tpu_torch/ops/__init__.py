"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Only what the serving slice runs is ported: the whole-gap Euler kernel.
Kernels build at first use (``_build.py``), never at import.
"""

from .gap_scan import (SUPPORTED_ACTS, GapWeights, gap_scan_available,
                       integrate_gap_fused, integrate_gap_reference,
                       split_weights)

__all__ = ["SUPPORTED_ACTS", "GapWeights", "gap_scan_available",
           "integrate_gap_fused", "integrate_gap_reference", "split_weights"]
