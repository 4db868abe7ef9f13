"""Plotting (port of ``njode_tpu.utils.plotting``; reference utils/plotting.py).

The trajectory plot rolls the model out with the one canonical grid
rollout, :meth:`NeuralJumpODE.predict_on_grid`.  The model holds its own
weights, so no ``params`` argument is taken.  Needs matplotlib, which
``njode_tpu_torch.utils`` imports only where it is installed.
"""

from __future__ import annotations

import json
from typing import List, Optional

import matplotlib

matplotlib.use("Agg")  # headless-safe
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def _load_history(history_path: str) -> Optional[dict]:
    """Read a run's history.json; None (with a diagnostic) if unreadable."""
    try:
        with open(history_path, "r") as f:
            return json.load(f)
    except FileNotFoundError:
        print(f"[plotting] no history at {history_path}; skipping")
    except json.JSONDecodeError as e:
        print(f"[plotting] {history_path} is not valid JSON ({e}); skipping")
    return None


def _finish(fig, save_path: Optional[str]):
    """Tight layout, optional save, always close."""
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def plot_training_history(history_path: str, save_path: Optional[str] = None):
    """Log-scale train/val loss on the left, epoch seconds on the right
    (reference utils/plotting.py:12-40)."""
    history = _load_history(history_path)
    if history is None:
        return

    fig, (ax_loss, ax_time) = plt.subplots(1, 2, figsize=(10, 6))
    for key, label in (("train_loss", "Training Loss"),
                       ("val_loss", "Validation Loss")):
        series = history.get(key)
        if series:
            ax_loss.plot(series, label=label, alpha=0.7)
    ax_loss.set(xlabel="Epoch", ylabel="Loss", yscale="log",
                title="Training History")
    ax_loss.legend()
    ax_loss.grid(True, alpha=0.3)

    ax_time.plot(history.get("epoch_times", []), alpha=0.7)
    ax_time.set(xlabel="Epoch", ylabel="Time (seconds)",
                title="Training Time per Epoch")
    ax_time.grid(True, alpha=0.3)

    _finish(fig, save_path)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def plot_single_trajectory_with_condexp(model, process_type: str,
                                        process_params: dict,
                                        obs_fraction: float = 0.1,
                                        seed: int = 123,
                                        save_path: Optional[str] = None,
                                        ensemble_params=None):
    """Figure-1 style plot (reference utils/plotting.py:43-309).

    Simulates one path on the model's device, subsamples observations, and
    overlays the true path, the model mean (±2σ bands when the variance is
    learned), the analytic conditional expectation (±2σ) and the
    observations.  ``ensemble_params`` (the JAX package's seed bands) is
    not ported and raises.
    """
    if ensemble_params is not None:
        raise NotImplementedError("ensembles are not ported yet "
                                  "(ROADMAP.md, Queue 1 item 11)")
    from ..simulation.moments import (
        condexp_black_scholes_on_grid, condexp_heston_on_grid,
        condexp_hybrid_on_grid, condexp_ou_on_grid,
        condvar_black_scholes_on_grid, condvar_heston_on_grid,
        condvar_ou_on_grid)
    from ..simulation.sde import (
        generate_black_scholes, generate_heston, generate_hybrid_ou_bs,
        generate_ou, sample_obs_indices)

    dev = model.device
    if process_type == "black_scholes":
        times_full, X_full = generate_black_scholes(seed=seed, device=dev,
                                                    **process_params)
    elif process_type == "ornstein_uhlenbeck":
        times_full, X_full = generate_ou(seed=seed, device=dev,
                                         **process_params)
    elif process_type == "heston":
        times_full, X_full, _ = generate_heston(seed=seed, device=dev,
                                                **process_params)
    elif process_type == "hybrid_ou_bs":
        times_full, X_full, switch_actual = generate_hybrid_ou_bs(
            seed=seed, device=dev, **process_params)
    else:
        raise ValueError(f"Unknown process type: {process_type}")

    G = times_full.shape[0]
    obs_idx = sample_obs_indices(
        1, G, obs_fraction,
        generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)[0]
    obs_times = times_full[obs_idx]
    obs_values = X_full[obs_idx]

    # analytic conditional expectation / variance on the dense grid
    if process_type == "black_scholes":
        ce = condexp_black_scholes_on_grid(times_full, X_full, obs_times,
                                           process_params.get("mu", 0.0))
    elif process_type == "ornstein_uhlenbeck":
        ce = condexp_ou_on_grid(times_full, X_full, obs_times,
                                process_params.get("theta", 1.0),
                                process_params.get("mu", 0.0))
    elif process_type == "heston":
        ce = condexp_heston_on_grid(times_full, X_full, obs_times,
                                    process_params.get("mu", 0.0))
    else:
        ce = condexp_hybrid_on_grid(times_full, X_full, obs_times,
                                    switch_time=float(switch_actual),
                                    theta_ou=process_params.get("theta_ou",
                                                                1.0),
                                    mu_ou=process_params.get("mu_ou", 0.0),
                                    mu_bs=process_params.get("mu_bs", 0.0))

    cv = None
    if model.num_moments > 1:
        if process_type == "black_scholes":
            cv = condvar_black_scholes_on_grid(
                times_full, X_full, obs_times,
                process_params.get("mu", 0.0),
                process_params.get("sigma", 0.2))
        elif process_type == "ornstein_uhlenbeck":
            cv = condvar_ou_on_grid(
                times_full, X_full, obs_times,
                process_params.get("theta", 1.0),
                process_params.get("sigma", 0.2))
        elif process_type == "heston":
            # the Heston variance approximation uses xi (vol-of-vol), as the
            # at-obs truths of the relative loss do
            cv = condvar_heston_on_grid(
                times_full, X_full, obs_times,
                process_params.get("mu", 0.0),
                process_params.get("xi", 0.5))

    # model rollout on the dense grid: the one canonical inference path
    obs_mask = torch.zeros(1, G, dtype=torch.bool, device=dev)
    obs_mask[0, obs_idx] = True
    out = model.predict_on_grid(times_full, obs_mask, X_full[None, :, None])
    model_mean = _np(out["mean"][0, :, 0])
    model_var = None if out["var"] is None else _np(out["var"][0, :, 0])

    # ---- draw ----
    t = _np(times_full)
    ce_np = _np(ce)
    fig = plt.figure(figsize=(12, 8))
    plt.plot(t, _np(X_full), "b-", label="True Path", linewidth=1.5)
    plt.plot(t, model_mean, "r-", label="Model Mean", linewidth=1.5)
    plt.plot(t, ce_np, "g:", label="True Conditional Expectation",
             linewidth=2)
    plt.scatter(_np(obs_times), _np(obs_values), c="black", s=30,
                label="Observations", zorder=5)

    if model_var is not None:
        std = np.sqrt(np.maximum(model_var, 0))
        plt.fill_between(t, model_mean - 2 * std, model_mean + 2 * std,
                         color="red", alpha=0.2, label="Model ±2σ")
        if cv is not None:
            tstd = np.sqrt(np.maximum(_np(cv), 0))
            plt.fill_between(t, ce_np - 2 * tstd, ce_np + 2 * tstd,
                             color="green", alpha=0.15, label="True ±2σ")

    plt.xlabel("Time")
    plt.ylabel("Value")
    title = (f"{process_type.replace('_', ' ').title()} Process - "
             f"Model vs True Conditional Expectation")
    if model_var is not None:
        title += " (with Variance)"
    plt.title(title)
    plt.legend()
    plt.grid(True, alpha=0.3)
    if save_path:
        plt.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def plot_relative_loss(history_paths: List[str], labels: List[str],
                       save_path: Optional[str] = None):
    """Overlay the relative-loss curves of several runs' history.json
    (reference utils/plotting.py:312-349).  A run whose history is missing,
    unparsable or without ``relative_loss`` is reported and skipped."""
    fig, ax = plt.subplots(figsize=(10, 6))

    drew_any = False
    for history_path, label in zip(history_paths, labels):
        history = _load_history(history_path)
        if history is None:
            continue
        series = history.get("relative_loss")
        if series is None:
            print(f"[plotting] {history_path} has no relative_loss series; "
                  "skipping")
            continue
        ax.plot(series, label=label, linewidth=2)
        drew_any = True

    ax.set(xlabel="Epoch",
           ylabel="Relative Loss (L_model - L_true) / L_true",
           title="Relative Loss: Model vs True Conditional Expectation")
    if drew_any:
        ax.legend()
    ax.grid(True, alpha=0.3)
    _finish(fig, save_path)


def plot_relative_loss_single(history_path: str,
                              save_path: Optional[str] = None):
    plot_relative_loss([history_path], ["Relative Loss"], save_path)
