"""Checkpoints with auto-resume semantics (port of the single-file branch of
``njode_tpu.utils.checkpoint``).

One ``torch.save`` bundle, like the reference's (reference
utils/training.py:289-308): ``model_state_dict``, ``optimizer_state_dict``
(``torch.optim.Adam``'s) and the four histories of :data:`HISTORY_KEYS`.
It is written to a side path first and then renamed over the old one, so an
interrupted job never leaves a torn checkpoint.  Orbax and multi-host
checkpoints are not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

HISTORY_KEYS = ("train_losses", "val_losses", "epoch_times", "relative_loss")


def save_checkpoint(path: str, model_state_dict: dict,
                    optimizer_state_dict: dict,
                    histories: dict[str, list]) -> None:
    """Write the bundle to ``path`` (side file, then an atomic rename)."""
    abspath = os.path.abspath(path)
    os.makedirs(os.path.dirname(abspath), exist_ok=True)
    bundle = {"model_state_dict": model_state_dict,
              "optimizer_state_dict": optimizer_state_dict,
              **{k: [float(x) for x in histories.get(k, [])]
                 for k in HISTORY_KEYS}}
    tmp = f"{abspath}.tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, abspath)


def load_checkpoint(path: str, map_location=None
                    ) -> tuple[dict, dict, dict[str, list]]:
    """(model_state_dict, optimizer_state_dict, histories) from ``path``.
    Raises on a missing or unreadable file; callers degrade to fresh
    training (reference utils/training.py:172-174)."""
    bundle = torch.load(path, map_location=map_location, weights_only=True)
    histories = {k: [float(x) for x in bundle.get(k, [])]
                 for k in HISTORY_KEYS}
    return (bundle["model_state_dict"], bundle["optimizer_state_dict"],
            histories)


def checkpoint_exists(path: Optional[str]) -> bool:
    return bool(path) and os.path.exists(path)
