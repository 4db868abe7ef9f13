"""The NJ-ODE loss over dense masked batches (port of ``njode_tpu.models.loss``).

* Mean (moment 0), per observation
  ``(sqrt(||X - Y||^2 + eps) + sqrt(||X - Y^-||^2 + eps))^2``, eps inside
  each sqrt (reference models/jump_ode.py:309-321).
* Variance (moment 1):
  - ``direct``: V = W^2 against Z = (X - Y_mean)^2 with the mean detached
    (the reference's ``.detach()``, :340-341);
  - ``second_moment``: V = W raw against Z = X^2, with no softplus (the
    reference's code, not its docstring, :349-353).
* Moments >= 2 contribute only with ``extended_moments=True``.
* Reduction: mean over observations per trajectory, weighted sum over
  moments, then mean over (valid) trajectories.
* ``ignore_first_continuity`` zeroes the continuity error at slot 0, so
  padding must sit at row ends.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

Tensor = torch.Tensor


def nj_ode_loss_dense(values: Tensor, preds: Tensor, preds_before: Tensor,
                      mask: Optional[Tensor] = None,
                      ignore_first_continuity: bool = False,
                      moment_weights=None, eps: float = 1e-10,
                      variance_method: str = "direct",
                      traj_mask: Optional[Tensor] = None,
                      extended_moments: bool = False) -> Tensor:
    """Dense masked NJ-ODE loss.

    Args:
      values:       (B, N, d_x) observed values X.
      preds:        (B, N, d_x, K) after-jump predictions.
      preds_before: (B, N, d_x, K) before-jump predictions.
      mask:         (B, N) bool, True at real observation slots (padding at
                    row ends); None = all valid.
      traj_mask:    (B,) bool validity of whole trajectories; None = all.

    Returns: the scalar loss.
    """
    X = values
    B, N = X.shape[:2]
    num_moments = preds.shape[-1]
    mask_f = (torch.ones((B, N), dtype=X.dtype, device=X.device)
              if mask is None else mask.to(X.dtype))
    n_obs = torch.clamp_min(mask_f.sum(dim=1), 1.0)

    def weight(k: int):
        return 1.0 if moment_weights is None else float(moment_weights[k])

    def two_term(jump_sq: Tensor, cont_sq: Tensor) -> Tensor:
        if ignore_first_continuity:
            cont_sq = torch.cat([torch.zeros_like(cont_sq[:, :1]),
                                 cont_sq[:, 1:]], dim=1)
        per_obs = (torch.sqrt(jump_sq + eps) + torch.sqrt(cont_sq + eps)) ** 2
        return (per_obs * mask_f).sum(dim=1) / n_obs

    Y, Yb = preds[..., 0], preds_before[..., 0]
    total = weight(0) * two_term(((X - Y) ** 2).sum(-1),
                                 ((X - Yb) ** 2).sum(-1))

    if num_moments > 1:
        W, Wb = preds[..., 1], preds_before[..., 1]
        if variance_method == "direct":
            V, Vb = W ** 2, Wb ** 2
            Z, Zb = (X - Y.detach()) ** 2, (X - Yb.detach()) ** 2
        elif variance_method == "second_moment":
            V, Vb = W, Wb
            Z = Zb = X ** 2
        else:
            raise ValueError(f"Unknown variance_method: {variance_method}")
        total = total + weight(1) * two_term(((Z - V) ** 2).sum(-1),
                                             ((Zb - Vb) ** 2).sum(-1))

    # moment index m >= 2 learns the (m+1)-th conditional moment: central
    # (direct, detached mean) or raw (second_moment) -- an extension beyond
    # the reference, which never trains them
    if extended_moments and num_moments > 2:
        for k in range(2, num_moments):
            p = k + 1
            Wk, Wkb = preds[..., k], preds_before[..., k]
            if variance_method == "direct":
                Zk, Zkb = (X - Y.detach()) ** p, (X - Yb.detach()) ** p
            else:
                Zk = Zkb = X ** p
            total = total + weight(k) * two_term(((Zk - Wk) ** 2).sum(-1),
                                                 ((Zkb - Wkb) ** 2).sum(-1))

    if traj_mask is None:
        return total.mean()
    tm = traj_mask.to(X.dtype)
    return (total * tm).sum() / torch.clamp_min(tm.sum(), 1.0)


def nj_ode_loss(batch_times, batch_values: Union[Tensor, Sequence[Tensor]],
                preds, preds_before, ignore_first_continuity: bool = False,
                moment_weights=None, eps: float = 1e-10,
                variance_method: str = "direct",
                mask: Optional[Tensor] = None,
                traj_mask: Optional[Tensor] = None,
                extended_moments: bool = False) -> Tensor:
    """Reference-compatible entry point: ragged per-trajectory lists or
    dense tensors.  ``batch_times`` is accepted for the signature and, as in
    the reference, never read except for the ragged lengths."""
    if isinstance(batch_values, (list, tuple)):
        from .jump_ode import pad_ragged
        _, values, m = pad_ragged(batch_times, batch_values,
                                  device=torch.as_tensor(preds[0]).device)
        N = values.shape[1]

        def densify(seq):
            rows = []
            for p in seq:
                p = torch.as_tensor(p, dtype=values.dtype)
                pad = torch.zeros((N - p.shape[0],) + tuple(p.shape[1:]),
                                  dtype=p.dtype, device=p.device)
                rows.append(torch.cat([p, pad]))
            return torch.stack(rows)

        return nj_ode_loss_dense(values, densify(preds), densify(preds_before),
                                 m, ignore_first_continuity, moment_weights,
                                 eps, variance_method,
                                 extended_moments=extended_moments)
    return nj_ode_loss_dense(batch_values, preds, preds_before, mask,
                             ignore_first_continuity, moment_weights, eps,
                             variance_method, traj_mask,
                             extended_moments=extended_moments)
