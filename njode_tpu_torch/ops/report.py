"""Kernel report: which CUDA kernel carries which piece of a run and, for a
kernel declined, the first reason (port of ``njode_tpu.ops.report``).

Under ``--kernels auto`` a configuration a kernel does not take goes on
without it; this line says so.  The Trainer prints it once a ``train()``
(rank 0 under a mesh).  The decisions come from the predicates that route
the work, and so do the reasons: the model's ``_walk_decline``,
``_fused_step_decline`` and ``_gap_decline``, ``_use_gap_scan`` and
``_use_fused``, and the Trainer's ``_kernel_decline`` for the whole-run
kernels.  They name the port's gates (``fused_step.AUTO_SHAPE_H100`` and
its neighbours, each kernel's ``MAX_HIDDEN``), and "not on a CUDA device"
where the JAX package says "not on TPU".
"""

from __future__ import annotations

from typing import Optional


def _walk_part(model) -> str:
    """The grid walk's kernels (rows 7-8)."""
    if model.dt_ode_step is None:
        return "walk=off (no --dt-ode-step (gaps are single Euler steps " \
               "already))"
    if not model.grid_walk:
        return ("walk=off (grid walk off (off-grid observation times, not "
                "on a CUDA device, a mesh or an ensemble, or --grid-walk "
                "off))")
    reason = model._walk_decline()
    return "walk=on" if reason is None else f"walk=off ({reason})"


def _gap_part(model) -> str:
    """The whole-gap kernel (row 1) and the gap loop's training pair (rows
    2-5)."""
    if model.dt_ode_step is None:
        return "gap=off (no --dt-ode-step)"
    if model._use_gap_scan():
        return "gap=on (forced: the training pair and inference)"
    if model._use_gap_scan(inference=True):
        return "gap=inference-only (validation and serving gaps)"
    return f"gap=off ({model._gap_decline or 'float32 only'})"


def kernel_report(model, *, n_rows: Optional[int] = None,
                  n_slots: Optional[int] = None,
                  train_kernel: Optional[str] = None,
                  model_axis: Optional[str] = None) -> str:
    """One line over the port's kernels.

    ``n_rows`` / ``n_slots``: the rows a training step gives the model
    (this rank's under a mesh) and the observation slots, where known.
    ``train_kernel``: the Trainer's own resolution of the whole-run
    kernels, "on", "on (walk twin)" or the first failing reason (the
    optimizer is out of the model's sight).  ``model_axis``: what the
    mesh's model axis holds on each rank (the Trainer's); under "moments"
    every rank's kernels take its block of the networks, the line names
    their count (Kn), equal on every rank."""
    parts = [_walk_part(model)]
    if train_kernel and train_kernel.startswith("on"):
        parts.append("train=" + train_kernel)
    elif train_kernel:
        parts.append(f"train=off ({train_kernel})")
    step = model._fused_step_decline(n_slots, n_rows)
    parts.append("step=on" if step is None else f"step=off ({step})")
    parts.append(_gap_part(model))
    parts.append("cell=on (forced)" if model._use_fused()
                 else "cell=opt-in (--kernels force)")
    if model_axis:
        parts.append(f"model axis={model_axis}, Kn={model.k_hidden} a rank")
    return "Kernels: " + "; ".join(parts)
