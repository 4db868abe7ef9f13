"""Checkpoints with auto-resume semantics (port of
``njode_tpu.utils.checkpoint``).

Two backends, by the JAX package's names:

* ``"msgpack"``: one ``torch.save`` bundle, like the reference's (reference
  utils/training.py:289-308): ``model_state_dict``,
  ``optimizer_state_dict`` (``torch.optim.Adam``'s) and the four histories
  of :data:`HISTORY_KEYS`.  An ensemble's bundle holds the stack of its
  members' state dicts, a list of their optimizer state dicts, and the
  (epochs, K) loss matrices of :data:`MEMBER_HISTORY_KEYS` too.  Under a
  process group rank 0 writes it and every rank waits at a barrier.
* ``"orbax"``: a ``torch.distributed.checkpoint`` directory, written by
  every rank together (the planner spreads the replicated tensors over the
  ranks' files).  Its state is flat: ``model/<key>`` and ``optim/<i>/<key>``
  tensors, and ``meta``, the rest (param groups, histories, the stack's
  shapes) as a ``torch.save`` byte string in a uint8 tensor.  Under the
  mesh's model axis each rank writes its own part of the one-process
  layout (``ModelShard.pieces``): a rank's row block of a tensor under
  ``<key>#<lo>:<hi>``, which :func:`load_checkpoint` joins back.

Both write to a side path first and then swap it in, so an interrupted job
never leaves a torn checkpoint, and either may replace the other.
:func:`load_checkpoint` tells a directory from a file.
"""

from __future__ import annotations

import io
import os
import shutil
import warnings
from typing import Optional

import torch

HISTORY_KEYS = ("train_losses", "val_losses", "epoch_times", "relative_loss")
MEMBER_HISTORY_KEYS = ("member_train_loss", "member_val_loss",
                       "member_relative_loss")
BACKENDS = ("msgpack", "orbax")


def _bundle(model_state_dict, optimizer_state_dict, histories) -> dict:
    return {"model_state_dict": model_state_dict,
            "optimizer_state_dict": optimizer_state_dict,
            **{k: [float(x) for x in histories.get(k, [])]
               for k in HISTORY_KEYS},
            **{k: [[float(x) for x in row] for row in histories[k]]
               for k in MEMBER_HISTORY_KEYS if k in histories}}


def _to_bytes(obj) -> torch.Tensor:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return torch.frombuffer(bytearray(buf.getvalue()), dtype=torch.uint8)


def _flat_state(bundle: dict) -> dict:
    """The bundle as DCP's flat state: ``model/<key>`` tensors,
    ``optim/<i>/<state index>/<key>`` tensors (one optimizer state, or one
    a member) and ``meta`` (everything else, as bytes)."""
    flat = {f"model/{k}": v for k, v in bundle["model_state_dict"].items()}
    osd = bundle["optimizer_state_dict"]
    states = osd if isinstance(osd, list) else [osd]
    groups = []
    for i, sd in enumerate(states):
        groups.append(sd["param_groups"])
        for j, st in sd["state"].items():
            for k, v in st.items():
                flat[f"optim/{i}/{j}/{k}"] = v
    meta = {k: v for k, v in bundle.items()
            if k not in ("model_state_dict", "optimizer_state_dict")}
    meta["param_groups"] = groups
    meta["optimizer_is_list"] = isinstance(osd, list)
    flat["meta"] = _to_bytes(meta)
    return flat


def _join_blocks(flat: dict) -> dict:
    """``flat`` with the row blocks ``<key>#<lo>:<hi>`` of a tensor joined
    into ``<key>``; raises where the blocks leave a gap."""
    out, blocks = {}, {}
    for k, v in flat.items():
        base, sep, span = k.partition("#")
        if not sep:
            out[k] = v
            continue
        lo, hi = map(int, span.split(":"))
        blocks.setdefault(base, []).append((lo, hi, v))
    for base, parts in blocks.items():
        parts.sort(key=lambda p: p[0])
        at = 0
        for lo, hi, v in parts:
            if lo != at or v.shape[0] != hi - lo:
                raise ValueError(f"{base}: row blocks "
                                 f"{[(p[0], p[1]) for p in parts]} leave a "
                                 "gap")
            at = hi
        out[base] = torch.cat([v for _, _, v in parts])
    return out


def _unflatten(flat: dict) -> dict:
    flat = _join_blocks(flat)
    meta = torch.load(io.BytesIO(flat["meta"].numpy().tobytes()),
                      weights_only=True)
    model = {k[len("model/"):]: v for k, v in flat.items()
             if k.startswith("model/")}
    states = [{"state": {}, "param_groups": g} for g in meta["param_groups"]]
    for key, v in flat.items():
        if key.startswith("optim/"):
            _, i, j, k = key.split("/")
            states[int(i)]["state"].setdefault(int(j), {})[k] = v
    osd = states if meta.pop("optimizer_is_list") else states[0]
    meta.pop("param_groups")
    return {"model_state_dict": model, "optimizer_state_dict": osd, **meta}


def _save_dcp(tmpdir: str, flat: dict) -> None:
    import torch.distributed.checkpoint as dcp
    from ..parallel.mesh import world
    # DCP plans with object collectives; it writes each rank's part
    single = world()[1] <= 1
    with warnings.catch_warnings():
        if single:      # the note that a single process writes
            warnings.simplefilter("ignore", UserWarning)
        dcp.save(flat, checkpoint_id=tmpdir, no_dist=single)


def _load_dcp(path: str) -> dict:
    """Every tensor of a DCP directory, read by this process alone (the
    state is replicated), templates from its metadata."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    meta = FileSystemReader(path).read_metadata()
    flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
            for k, m in meta.state_dict_metadata.items()
            if isinstance(m, TensorStorageMetadata)}
    with warnings.catch_warnings():
        # no_dist: the note that a single process reads
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(flat, checkpoint_id=path, no_dist=True)
    return flat


def save_checkpoint(path: str, model_state_dict: dict,
                    optimizer_state_dict: dict | list,
                    histories: dict[str, list],
                    backend: str = "msgpack") -> None:
    """Write the checkpoint to ``path`` (a side path, then a swap).  Under
    a process group every rank calls it: the single file is written by
    rank 0 (the ranks' states are equal, or gathered into the one-process
    layout), the directory by every rank (each its part)."""
    from ..parallel.mesh import barrier, is_primary
    if backend not in BACKENDS:
        raise ValueError(f"Unknown checkpoint backend: {backend}")
    abspath = os.path.abspath(path)
    primary = is_primary()
    if primary:
        os.makedirs(os.path.dirname(abspath), exist_ok=True)
    bundle = _bundle(model_state_dict, optimizer_state_dict, histories)
    if backend == "orbax":
        tmpdir = abspath + ".tmp_dcp"
        if primary and os.path.isdir(tmpdir):
            shutil.rmtree(tmpdir)
        barrier()
        _save_dcp(tmpdir, _flat_state(bundle))
        barrier()
        if primary:
            if os.path.isdir(abspath):
                shutil.rmtree(abspath)
            elif os.path.isfile(abspath):   # over an old single file
                os.remove(abspath)
            os.rename(tmpdir, abspath)
        barrier()
        return
    if primary:
        tmp = f"{abspath}.tmp"
        torch.save(bundle, tmp)
        if os.path.isdir(abspath):          # over an old directory
            shutil.rmtree(abspath)
        os.replace(tmp, abspath)
    barrier()


def load_checkpoint(path: str, map_location=None
                    ) -> tuple[dict, dict, dict[str, list]]:
    """(model_state_dict, optimizer_state_dict, histories) from ``path``,
    a file or a directory.  Raises on a missing or unreadable checkpoint;
    callers degrade to fresh training (reference
    utils/training.py:172-174)."""
    if os.path.isdir(path):
        bundle = _unflatten(_load_dcp(path))
        if map_location is not None:
            bundle["model_state_dict"] = {
                k: v.to(map_location)
                for k, v in bundle["model_state_dict"].items()}
    else:
        bundle = torch.load(path, map_location=map_location,
                            weights_only=True)
    histories = {k: [float(x) for x in bundle.get(k, [])]
                 for k in HISTORY_KEYS}
    histories.update({k: bundle[k] for k in MEMBER_HISTORY_KEYS
                      if k in bundle})
    return (bundle["model_state_dict"], bundle["optimizer_state_dict"],
            histories)


def checkpoint_exists(path: Optional[str]) -> bool:
    return bool(path) and os.path.exists(path)
