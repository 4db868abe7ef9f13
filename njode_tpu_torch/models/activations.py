"""Activation registry (PyTorch port of ``njode_tpu.models.activations``).

Mirrors the reference's ``ACTIVATION_FUNCTIONS`` mapping including the
silent ReLU fallback for unknown names (reference: models/jump_ode.py:6-13,18
— ``ACTIVATION_FUNCTIONS.get(activation.lower(), nn.ReLU)``).  The fallback
is load-bearing: the OU experiment CLI ships an ``'identity'`` default that
resolves to ReLU through it (reference: experiments/experiment_ou.py:30).

Activations are ``nn.Module`` classes, as in the reference, so the MLPs'
``nn.Sequential`` layouts (and their state-dict indices) match it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

ACTIVATION_FUNCTIONS: dict[str, type[nn.Module]] = {
    "relu": nn.ReLU,
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
    "elu": nn.ELU,               # alpha=1.0
    "leaky_relu": nn.LeakyReLU,  # negative_slope=0.01
    "selu": nn.SELU,
}


def get_activation(name: str) -> nn.Module:
    """A fresh activation module by name, with the reference's ReLU fallback."""
    return ACTIVATION_FUNCTIONS.get(name.lower(), nn.ReLU)()


def canonical_activation(name: str) -> str:
    """The table key :func:`get_activation` actually resolves ``name`` to
    (unknown names -> ``'relu'``, the reference's silent fallback).

    Kernel eligibility and the CUDA kernel's activation enum consume THIS,
    never the raw config string."""
    n = name.lower()
    return n if n in ACTIVATION_FUNCTIONS else "relu"


def canonical_input_scaling(name: str) -> str:
    """The scaling key :func:`get_input_scaling` resolves to
    (``'none'`` is the reference's alias for identity)."""
    n = name.lower()
    return "identity" if n in ("identity", "none") else n


def get_input_scaling(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Input-scaling function of the ODE drift network
    (reference: models/jump_ode.py:43-50)."""
    if name in ("identity", "none"):
        return lambda x: x
    if name == "tanh":
        return torch.tanh
    if name == "sigmoid":
        return torch.sigmoid
    raise ValueError(
        f"Unknown input_scaling: {name}. Use 'identity', 'tanh', or 'sigmoid'."
    )
