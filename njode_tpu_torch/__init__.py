"""njode_tpu_torch — Neural Jump ODEs in PyTorch, with CUDA kernels for Hopper.

The PyTorch port of ``njode_tpu``, which stays beside it as the reference.
It keeps that package's module layout and names.  This slice serves trained
models:

* ``NeuralJumpODE.predict_at`` answers batched (stream, time) queries;
* ``NJODEFilter`` is the O(1)-state streaming filter;
* ``ops.integrate_gap_fused`` runs each gap's Euler substep loop in one
  hand-written CUDA kernel (``ops/csrc/gap_scan.cu``), built with ``nvcc``
  at first use, with its plain PyTorch version for CPU tensors;
* ``simulation.simulate_batch`` makes Black-Scholes requests.

The package imports ``torch`` and never ``jax``.
"""

from .models import NeuralJumpODE
from .serving import NJODEFilter

__version__ = "0.1.0"

__all__ = ["NeuralJumpODE", "NJODEFilter", "__version__"]
