"""Utilities: training, checkpoints and the weight bridge from the JAX
package."""

from .checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from .training import (DataLoader, Trainer, create_data_loaders, make_adam,
                       run_experiment)
from .weights import adam_state_from_jax, state_dict_from_jax

__all__ = ["DataLoader", "Trainer", "adam_state_from_jax",
           "checkpoint_exists", "create_data_loaders", "load_checkpoint",
           "make_adam", "run_experiment", "save_checkpoint",
           "state_dict_from_jax"]
