"""The three NJ-ODE networks as ``nn.Module``s (port of ``njode_tpu.models.mlp``).

The layer orders reproduce the reference's, which differ from each other
(observable through parameter counts and dropout placement):

* JumpNN    (reference models/jump_ode.py:15-26):
    Linear(d_x, d_h), act, then n_hidden_layers x [Dropout, Linear(d_h,d_h), act]
* ODEFunc   (reference models/jump_ode.py:29-63):
    Linear(d_h+d_x+2, d_h), act, (n_hidden_layers-1) x [Dropout, Linear, act],
    Dropout, Linear(d_h, d_h)          (no final activation)
* OutputNN  (reference models/jump_ode.py:66-77):
    n_hidden_layers x [Linear(d_h,d_h), act, Dropout], Linear(d_h, d_out)

Each network keeps its layers in an ``nn.Sequential`` named ``net``, so the
Linear layers sit at the reference's state-dict indices
(:func:`linear_indices`).  Initialisation is torch's ``nn.Linear`` default
law — weight and bias ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)) — drawn from an
explicit ``torch.Generator`` on the CPU, so a seed gives the same weights
whatever device the model then moves to.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .activations import get_activation


def linear_indices(kind: str, n_hidden_layers: int) -> list[int]:
    """Positions of the Linear modules inside each network's ``net``.

    JumpNN:   [Linear, act] + n x [Drop, Linear, act]        -> 0, 3, 6, ...
    ODEFunc:  [Linear, act] + (n-1) x [Drop, Linear, act] + [Drop, Linear]
    OutputNN: n x [Linear, act, Drop] + [Linear]             -> 0, 3, ..., 3n
    (reference models/jump_ode.py:19-21, 36-39, 70-74).  The three orders
    differ but put their Linears at the same positions, every third module.
    """
    if kind not in ("jump", "ode", "out"):
        raise ValueError(kind)
    return [3 * i for i in range(n_hidden_layers + 1)]


def _linear(fan_in: int, fan_out: int,
            generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
        nn.init.uniform_(layer.bias, -bound, bound, generator=generator)
    return layer


class JumpNN(nn.Module):
    """x: (..., d_x) -> h: (..., d_h). Dropout precedes every hidden Linear."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 n_hidden_layers: int = 1, activation: str = "relu",
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [_linear(input_dim, hidden_dim, generator),
                  get_activation(activation)]
        for _ in range(n_hidden_layers):
            layers += [nn.Dropout(dropout_rate),
                       _linear(hidden_dim, hidden_dim, generator),
                       get_activation(activation)]
        self.net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class ODEFunc(nn.Module):
    """inp: (..., d_h+d_x+2) -> dh/dt (..., d_h). Final Linear has no activation."""

    def __init__(self, hidden_dim: int, input_dim: int,
                 n_hidden_layers: int = 1, activation: str = "relu",
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [_linear(hidden_dim + input_dim + 2, hidden_dim, generator),
                  get_activation(activation)]
        for _ in range(n_hidden_layers - 1):
            layers += [nn.Dropout(dropout_rate),
                       _linear(hidden_dim, hidden_dim, generator),
                       get_activation(activation)]
        layers += [nn.Dropout(dropout_rate),
                   _linear(hidden_dim, hidden_dim, generator)]
        self.net = nn.Sequential(*layers)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self.net(inp)


class OutputNN(nn.Module):
    """h: (..., d_h) -> (..., d_out). Dropout follows each hidden activation."""

    def __init__(self, hidden_dim: int, output_dim: int,
                 n_hidden_layers: int = 1, activation: str = "relu",
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        for _ in range(n_hidden_layers):
            layers += [_linear(hidden_dim, hidden_dim, generator),
                       get_activation(activation),
                       nn.Dropout(dropout_rate)]
        layers += [_linear(hidden_dim, output_dim, generator)]
        self.net = nn.Sequential(*layers)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.net(h)


def linears(module: nn.Module) -> list[nn.Linear]:
    """The Linear layers of a network's ``net``, in order."""
    return [m for m in module.net if isinstance(m, nn.Linear)]
