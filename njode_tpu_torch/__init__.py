"""njode_tpu_torch — Neural Jump ODEs in PyTorch, with CUDA kernels for Hopper.

The PyTorch port of ``njode_tpu``, which stays beside it as the reference.
It keeps that package's module layout and names.  Ported so far:

* training: ``utils.run_experiment(config)`` and ``utils.Trainer`` train the
  default Black-Scholes recipe, where ``ops.fused_train_run`` runs each
  epoch's Adam steps in one hand-written CUDA kernel
  (``ops/csrc/train_run.cu``), and the production recipe (shared network,
  ``dt_ode_step``, the grid walk), where ``ops.fused_walk_train_run`` does
  (``ops/csrc/walk_train.cu``) and the grid walk of ``apply`` runs in a
  CUDA kernel pair, forward and backward (``ops.walk_gaps_fused``,
  ``ops/csrc/walk_scan.cu``);
* serving: ``NeuralJumpODE.predict_at`` answers batched (stream, time)
  queries and ``NJODEFilter`` is the O(1)-state streaming filter;
  ``ops.integrate_gap_fused`` runs each gap's Euler substep loop in one
  CUDA kernel (``ops/csrc/gap_scan.cu``);
* inference on a grid: ``NeuralJumpODE.predict_on_grid`` (the rollout that
  ``utils.plotting`` draws) and ``sample_paths``, the moment-matched
  autoregressive sampler, whose every grid step is one gap-kernel launch;
* the experiment CLIs: ``python -m
  njode_tpu_torch.experiments.experiment_{black_scholes,ou,heston,hybrid}``
  and ``compare_experiments``, with the JAX package's flags;
* data: ``simulation.simulate_batch`` (Black-Scholes, OU, Heston, hybrid
  OU->BS, the d-dimensional BS and OU, and registered processes; grid or
  obs-only) and ``simulation.moments_at_obs``, which training takes for
  the relative loss.

Kernels are built with ``nvcc`` at first use; each has its plain PyTorch
version, which CPU tensors take.  Models, the Trainer and
``run_experiment`` run on ``cuda`` unless the caller asks for the CPU.
The package imports ``torch`` and never ``jax``.
"""

from .generative import sample_paths
from .models import NeuralJumpODE, nj_ode_loss
from .serving import NJODEFilter
from .utils import Trainer, run_experiment

__version__ = "0.3.0"

__all__ = ["NeuralJumpODE", "nj_ode_loss", "NJODEFilter", "sample_paths",
           "Trainer", "run_experiment", "__version__"]
