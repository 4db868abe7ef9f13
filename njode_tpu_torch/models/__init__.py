"""Model layer: NeuralJumpODE and its networks."""

from .activations import (ACTIVATION_FUNCTIONS, get_activation,
                          get_input_scaling)
from .jump_ode import NeuralJumpODE, pad_ragged

__all__ = ["NeuralJumpODE", "pad_ragged", "ACTIVATION_FUNCTIONS",
           "get_activation", "get_input_scaling"]
