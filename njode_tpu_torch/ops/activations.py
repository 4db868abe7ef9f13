"""Activation and input-scaling tables shared by the kernels' plain versions.

``_ACT``/``_SCALE`` are the forward functions; ``_ACT_GRAD``/``_SCALE_GRAD``
their derivatives, written out for the hand-written backward of the
training kernel (port of ``njode_tpu/ops/fused_cell.py:42-63`` and
``njode_tpu/ops/gap_scan.py`` ``_SCALE_GRAD``).  ``_ACT_GRAD`` takes the
pre-activation, ``_SCALE_GRAD`` the unscaled input.  The CUDA kernels
number the activations and scalings by their positions in
``SUPPORTED_ACTS`` and ``SCALINGS``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

_SELU_L = 1.0507009873554805  # selu scale / alpha, as in jax.nn.selu
_SELU_A = 1.6732632423543772

Fn = Callable[[torch.Tensor], torch.Tensor]

_ACT: dict[str, Fn] = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,                                   # alpha 1
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "selu": lambda x: _SELU_L * torch.where(x > 0, x, _SELU_A * torch.expm1(x)),
}
_ACT_GRAD: dict[str, Fn] = {
    "relu": lambda pre: (pre > 0).to(pre.dtype),
    "tanh": lambda pre: 1.0 - torch.tanh(pre) ** 2,
    "sigmoid": lambda pre: torch.sigmoid(pre) * (1 - torch.sigmoid(pre)),
    "elu": lambda pre: torch.where(pre > 0, 1.0,
                                   torch.exp(torch.clamp_max(pre, 0.0))),
    "leaky_relu": lambda pre: torch.where(pre > 0, 1.0, 0.01),
    "selu": lambda pre: torch.where(
        pre > 0, _SELU_L,
        _SELU_L * _SELU_A * torch.exp(torch.clamp_max(pre, 0.0))),
}
_SCALE: dict[str, Fn] = {
    "identity": lambda x: x,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}
_SCALE_GRAD: dict[str, Fn] = {
    "identity": lambda x: torch.ones_like(x),
    "tanh": lambda x: 1.0 - torch.tanh(x) ** 2,
    "sigmoid": lambda x: torch.sigmoid(x) * (1.0 - torch.sigmoid(x)),
}
SUPPORTED_ACTS = tuple(_ACT)
SCALINGS = tuple(_SCALE)
# activations and scalings with f(0) = 0 (njode_tpu/ops/fused_step.py:126-132)
ZERO_PRESERVING_ACTS = tuple(a for a in SUPPORTED_ACTS if a != "sigmoid")
ZERO_PRESERVING_SCALINGS = ("identity", "tanh")


def packed_state_safe(activation: str, input_scaling: str) -> bool:
    """Whether both map 0 to 0 (the JAX kernels' scope for training)."""
    return (activation in ZERO_PRESERVING_ACTS
            and input_scaling in ZERO_PRESERVING_SCALINGS)
