"""Weights carried from the JAX package into the port.

The JAX package keeps parameters as a pytree
``{"jump"|"ode"|"out": {"layers": [{"w": (in, out), "b": (out,)}, ...]}}``,
with a leading K axis on every leaf in separate-network mode.  The port's
modules use the reference's names and torch's (out, in) orientation, so one
state dict loads into both the port and a reference model:

* shared mode: ``jump_nn.net.{i}.weight``, ``ode_func...``, ``output_nn...``;
* separate mode: ``jump_nns.{m}.net.{i}...``, ``ode_funcs...``,
  ``output_nns...``,

with ``i`` the Linear positions of :func:`..models.mlp.linear_indices`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..models.mlp import linear_indices

_NAMES = {"jump": ("jump_nn", "jump_nns"), "ode": ("ode_func", "ode_funcs"),
          "out": ("output_nn", "output_nns")}


def state_dict_from_jax(params: Mapping[str, Any], *, num_moments: int,
                        shared_network: bool,
                        n_hidden_layers: int) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy-convertible leaves) -> port state dict."""
    out: dict[str, torch.Tensor] = {}
    for m in [None] if shared_network else range(num_moments):
        for kind, (shared_name, stacked_name) in _NAMES.items():
            layers = params[kind]["layers"]
            idxs = linear_indices(kind, n_hidden_layers)
            if len(idxs) != len(layers):
                raise ValueError(f"{kind}: {len(layers)} layers in the "
                                 f"pytree, {len(idxs)} expected for "
                                 f"n_hidden_layers={n_hidden_layers}")
            prefix = shared_name if m is None else f"{stacked_name}.{m}"
            for pos, layer in zip(idxs, layers):
                w = np.asarray(layer["w"], dtype=np.float32)
                b = np.asarray(layer["b"], dtype=np.float32)
                if m is not None:
                    w, b = w[m], b[m]
                out[f"{prefix}.net.{pos}.weight"] = torch.tensor(w.T.copy())
                out[f"{prefix}.net.{pos}.bias"] = torch.tensor(b.copy())
    return out
