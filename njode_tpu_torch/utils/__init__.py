"""Utilities: training, checkpoints, the evaluation metrics, profiling, the
weight bridge from the JAX package and, where matplotlib is installed,
plotting."""

from .checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from .metrics import conditional_moment_mse, relative_loss
from .training import (DataLoader, Trainer, as_dense, create_data_loaders,
                       make_adam, run_experiment)
from .weights import adam_state_from_jax, state_dict_from_jax

__all__ = ["DataLoader", "Trainer", "adam_state_from_jax", "as_dense",
           "checkpoint_exists", "conditional_moment_mse",
           "create_data_loaders", "load_checkpoint", "make_adam",
           "relative_loss", "run_experiment", "save_checkpoint",
           "state_dict_from_jax"]

# the plotting names only where matplotlib imports; any other import
# failure of the module propagates
try:
    from .plotting import (plot_relative_loss, plot_relative_loss_single,
                           plot_single_trajectory_with_condexp,
                           plot_training_history)
except ImportError as e:
    if (e.name or "").split(".")[0] != "matplotlib":
        raise
else:
    __all__ += ["plot_relative_loss", "plot_relative_loss_single",
                "plot_single_trajectory_with_condexp",
                "plot_training_history"]
