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
:func:`adam_state_from_jax` carries an optax Adam state over in the same
names, as a ``torch.optim.Adam`` ``state_dict``.
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


def _find_adam(opt_state):
    """The (count, mu, nu) entry of an optax chain state, found by its
    fields (the port imports no optax)."""
    for s in opt_state if isinstance(opt_state, (tuple, list)) else [opt_state]:
        if all(hasattr(s, f) for f in ("count", "mu", "nu")):
            return s
    raise ValueError("optimizer state has no (count, mu, nu) Adam entry")


def adam_state_from_jax(opt_state, model, *, lr: float,
                        weight_decay: float = 0.0, betas=(0.9, 0.999),
                        eps: float = 1e-8) -> dict:
    """optax ``ScaleByAdamState`` (count, mu, nu) of the JAX ``make_adam``
    chain -> a ``torch.optim.Adam`` ``state_dict`` for ``model``'s
    parameters (step, exp_avg, exp_avg_sq, indexed in the order of
    ``model.parameters()`` and named through :func:`state_dict_from_jax`)."""
    adam = _find_adam(opt_state)
    kw = dict(num_moments=model.num_moments,
              shared_network=model.shared_network,
              n_hidden_layers=model.n_hidden_layers)
    mu, nu = state_dict_from_jax(adam.mu, **kw), state_dict_from_jax(adam.nu, **kw)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    names = [n for n, _ in model.named_parameters()]
    dev = next(model.parameters()).device
    state = {i: {"step": step.clone(), "exp_avg": mu[n].to(dev),
                 "exp_avg_sq": nu[n].to(dev)} for i, n in enumerate(names)}
    groups = torch.optim.Adam(model.parameters(), lr=lr, betas=tuple(betas),
                              eps=eps, weight_decay=weight_decay
                              ).state_dict()["param_groups"]
    return {"state": state, "param_groups": groups}
