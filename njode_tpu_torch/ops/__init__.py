"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions:
the whole-gap Euler kernel (serving) and its training pair, the fused Euler
cell, the whole-run training kernel, the grid-walk kernel pair, the
whole-run walk-train kernel (production training) and the fused whole step
(scaled training).  Kernels build at first use (``_build.py``), never at
import.
"""

from .fused_cell import (FusedEulerCell, fused_cell_available,
                         fused_euler_cell, ode_euler_fused,
                         ode_euler_reference)
from .fused_step import (fused_step_apply, fused_step_available,
                         fused_step_loss)
from .gap_scan import (SUPPORTED_ACTS, GapScan, GapWeights,
                       gap_scan_available, gap_train_fits,
                       integrate_gap_fused, integrate_gap_reference,
                       split_weights)
from .train_kernel import (TrainState, fused_train_run,
                           fused_train_run_reference, init_train_state,
                           kernel_state_from, optax_state_into,
                           pack_minibatches, train_kernel_available,
                           train_state_params)
from .walk_scan import (WalkScan, walk_gaps_fused, walk_gaps_reference,
                        walk_scan_available)
from .walk_train import (WalkState, fused_walk_train_run,
                         fused_walk_train_run_reference, init_walk_state,
                         optax_state_into_walk, walk_state_from,
                         walk_train_available, walk_train_params)

__all__ = ["FusedEulerCell", "fused_cell_available", "fused_euler_cell",
           "ode_euler_fused", "ode_euler_reference", "fused_step_apply",
           "fused_step_available", "fused_step_loss", "SUPPORTED_ACTS",
           "GapScan", "GapWeights", "gap_scan_available", "gap_train_fits", "integrate_gap_fused",
           "integrate_gap_reference", "split_weights",
           "TrainState", "fused_train_run", "fused_train_run_reference",
           "init_train_state", "kernel_state_from", "optax_state_into",
           "pack_minibatches", "train_kernel_available",
           "train_state_params", "WalkScan", "walk_gaps_fused",
           "walk_gaps_reference", "walk_scan_available", "WalkState",
           "fused_walk_train_run", "fused_walk_train_run_reference",
           "init_walk_state", "optax_state_into_walk", "walk_state_from",
           "walk_train_available", "walk_train_params"]
