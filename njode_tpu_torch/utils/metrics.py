"""Standalone evaluation metrics (port of ``njode_tpu.utils.metrics``).

* :func:`relative_loss`: the paper's headline metric ``(L_model - L_true) /
  L_true`` against the closed-form conditional-moment truths (reference
  utils/training.py:219-255).
* :func:`conditional_moment_mse`: the MSE of the before-jump conditional
  mean and variance against the closed forms.

The JAX functions take the model and its parameter pytree; a port model
holds its parameters, so the port's take the model alone and evaluate it
without autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import NeuralJumpODE, nj_ode_loss_dense
from ..simulation import TrajectoryBatch
from ..simulation.moments import moments_at_obs


def _truths(model: NeuralJumpODE, batch: TrajectoryBatch, process_type: str,
            variance_method: str, use_batch_switch_times: bool,
            **process_params):
    switch_times = batch.switch_times if use_batch_switch_times else None
    return moments_at_obs(batch.times, batch.values, process_type,
                          num_moments=model.num_moments,
                          variance_method=variance_method, mask=batch.mask,
                          switch_times=switch_times, **process_params)


def relative_loss(model: NeuralJumpODE, batch: TrajectoryBatch,
                  process_type: str, moment_weights=None,
                  variance_method: str = "direct",
                  use_batch_switch_times: bool = False,
                  **process_params) -> float:
    """(L_model - L_true) / max(L_true, 1e-8) on a trajectory batch
    (``njode_tpu/utils/metrics.py:105``)."""
    with torch.no_grad():
        preds, preds_before = model.apply(batch.times, batch.values,
                                          batch.mask)
        l_model = nj_ode_loss_dense(batch.values, preds, preds_before,
                                    batch.mask, moment_weights=moment_weights,
                                    variance_method=variance_method)
        yt, ytb = _truths(model, batch, process_type, variance_method,
                          use_batch_switch_times, **process_params)
        l_true = nj_ode_loss_dense(batch.values, yt, ytb, batch.mask,
                                   moment_weights=moment_weights,
                                   variance_method=variance_method)
        return float((l_model - l_true) / torch.clamp_min(l_true, 1e-8))


def conditional_moment_mse(model: NeuralJumpODE, batch: TrajectoryBatch,
                           process_type: str,
                           variance_method: str = "direct",
                           use_batch_switch_times: bool = False,
                           **process_params) -> dict:
    """Per-element MSE of the before-jump mean and variance predictions
    against the closed forms (``njode_tpu/utils/metrics.py:116``).  Slot 0
    is left out (its truth is the observation itself).  Returns {'mean':
    float, 'var': float, or None for a one-moment model}."""
    with torch.no_grad():
        _, preds_before = model.apply(batch.times, batch.values, batch.mask)
        _, ytb = _truths(model, batch, process_type, variance_method,
                         use_batch_switch_times, **process_params)
        d_out = preds_before.shape[2]
        m = batch.mask[:, 1:, None].to(preds_before.dtype)
        denom = torch.clamp_min(m.sum() * d_out, 1.0)    # elements, not slots
        mse_mean = (((preds_before[:, 1:, :, 0] - ytb[:, 1:, :, 0]) ** 2)
                    * m).sum() / denom
        mse_var: Optional[float] = None
        if model.num_moments > 1:
            w = preds_before[:, 1:, :, 1]
            var_pred = w ** 2 if variance_method == "direct" else w
            mse_var = float((((var_pred - ytb[:, 1:, :, 1]) ** 2) * m).sum()
                            / denom)
    return {"mean": float(mse_mean), "var": mse_var}
