"""njode_tpu_torch — Neural Jump ODEs in PyTorch, with CUDA kernels for Hopper.

The PyTorch port of ``njode_tpu``, which stays beside it as the reference.
It keeps that package's module layout and names.  Ported so far:

* training: ``utils.run_experiment(config)`` and ``utils.Trainer`` train the
  default Black-Scholes recipe; ``ops.fused_train_run`` runs each epoch's
  Adam steps in one hand-written CUDA kernel (``ops/csrc/train_run.cu``);
* serving: ``NeuralJumpODE.predict_at`` answers batched (stream, time)
  queries and ``NJODEFilter`` is the O(1)-state streaming filter;
  ``ops.integrate_gap_fused`` runs each gap's Euler substep loop in one
  CUDA kernel (``ops/csrc/gap_scan.cu``);
* data: ``simulation.simulate_batch`` (Black-Scholes, grid or obs-only) and
  ``simulation.moments_at_obs``.

Kernels are built with ``nvcc`` at first use; each has its plain PyTorch
version, which CPU tensors take.  Models, the Trainer and
``run_experiment`` run on ``cuda`` unless the caller asks for the CPU.
The package imports ``torch`` and never ``jax``.
"""

from .models import NeuralJumpODE
from .serving import NJODEFilter
from .utils import Trainer, run_experiment

__version__ = "0.2.0"

__all__ = ["NeuralJumpODE", "NJODEFilter", "Trainer", "run_experiment",
           "__version__"]
