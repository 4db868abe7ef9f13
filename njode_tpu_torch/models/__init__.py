"""Model layer: NeuralJumpODE, its networks and the NJ-ODE loss."""

from .activations import (ACTIVATION_FUNCTIONS, get_activation,
                          get_input_scaling)
from .jump_ode import NeuralJumpODE, pad_ragged, resolve_device
from .loss import nj_ode_loss, nj_ode_loss_dense

__all__ = ["NeuralJumpODE", "pad_ragged", "resolve_device", "nj_ode_loss",
           "nj_ode_loss_dense", "ACTIVATION_FUNCTIONS", "get_activation",
           "get_input_scaling"]
