"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions:
the whole-gap Euler kernel (serving) and the whole-run training kernel.
Kernels build at first use (``_build.py``), never at import.
"""

from .gap_scan import (SUPPORTED_ACTS, GapWeights, gap_scan_available,
                       integrate_gap_fused, integrate_gap_reference,
                       split_weights)
from .train_kernel import (TrainState, fused_train_run,
                           fused_train_run_reference, init_train_state,
                           kernel_state_from, optax_state_into,
                           pack_minibatches, train_kernel_available,
                           train_state_params)

__all__ = ["SUPPORTED_ACTS", "GapWeights", "gap_scan_available",
           "integrate_gap_fused", "integrate_gap_reference", "split_weights",
           "TrainState", "fused_train_run", "fused_train_run_reference",
           "init_train_state", "kernel_state_from", "optax_state_into",
           "pack_minibatches", "train_kernel_available",
           "train_state_params"]
