"""This rank's part of a model on the mesh's model axis.

The JAX package shards parameters and Adam state over 'model' and lets
GSPMD partition the program (``njode_tpu/parallel/mesh.py:86-108``,
``njode_tpu/utils/training.py:296-309``).  The port decides by hand:

* **"moments"** (expert parallelism over the K separate networks): the
  model keeps this rank's block of K / M networks
  (:meth:`NeuralJumpODE.shard_moments`); every route runs them alone and
  the readout is gathered into all K moments once a forward.  The loss,
  the same on every rank of the model group, reaches each network through
  its own slice of the gathered outputs.  A shared network has no moment
  axis and stays whole on every rank, as does a K the axis does not
  divide.
* **"hidden"** (the hidden feature axis): each rank holds and steps the
  row blocks of every weight and bias whose output width M divides (torch's
  leading axis is JAX's trailing one), and their Adam state; the module
  keeps whole networks, which the blocks refill after every step in one
  gather, so the forward and every kernel route run unchanged.  Each rank
  computes the same rows, so a block's gradient is its slice of the whole
  network's gradient (no sum over the model axis).

Checkpoints keep the one-process layout: :meth:`ModelShard.model_state`
and :meth:`ModelShard.optimizer_state` gather it (collective over the
model group), :meth:`ModelShard.load` cuts this rank's part from it, and
:meth:`ModelShard.pieces` is this rank's own part for a
``torch.distributed.checkpoint`` directory (a block named ``key#lo:hi``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .collectives import join
from .mesh import moment_block, network_index, param_rows

MODES = ("moments", "hidden")


def model_axis_note(mode: str, shared_network: bool, num_moments: int,
                    n_model: int) -> str:
    """What the model axis holds on each rank, for the Distributed line and
    the kernel report."""
    if mode == "hidden":
        return ("hidden: every weight and bias whose output width the axis "
                "divides in row blocks, with their Adam state; the forward "
                "runs whole networks, gathered once a step")
    if shared_network:
        return ("moments: a shared network has no moment axis; replicated "
                "on the model axis")
    if moment_block(num_moments, n_model, 0) is None:
        return (f"moments: K={num_moments} does not divide over {n_model}; "
                "replicated on the model axis")
    return (f"moments: {num_moments // n_model} of the {num_moments} "
            "networks on each rank")


@dataclass
class _Owned:
    """A parameter of the one-process model this rank steps: its index in
    ``named_parameters`` order (Adam's), its name there, the tensor the
    optimizer holds, and how it lies on the model axis: "network" (this
    rank's alone), "rows" (this rank's row block ``rows``) or
    "replicated" (every rank's)."""
    index: int
    name: str
    tensor: torch.Tensor
    kind: str
    rows: Optional[slice] = None


class ModelShard:
    """This rank's part of ``model`` on ``mesh``'s model axis under
    ``mode`` ("moments" or "hidden"; module docstring).  Built on every
    rank together, after rank 0's weights were broadcast; cuts the model
    in place under "moments".  ``mesh`` None is a model axis of one rank:
    nothing is cut."""

    def __init__(self, mesh, model, mode: str):
        if mode not in MODES:
            raise ValueError(f"Unknown model_shard: {mode!r} (one of 'none', "
                             "'moments', 'hidden')")
        self.mesh, self.model, self.mode = mesh, model, mode
        self.n_model = mesh.n_model if mesh is not None else 1
        r = mesh.model_rank if mesh is not None else 0
        self.primary = r == 0        # adds what every model rank holds
        # the one-process layout: state keys and shapes, Adam's order
        full = model.state_dict()
        self.full_keys = list(full)
        self.full_shapes = {k: tuple(v.shape) for k, v in full.items()}
        self.full_dtypes = {k: v.dtype for k, v in full.items()}
        self.names = [n for n, _ in model.named_parameters()]
        self.block = None
        if mode == "moments" and not model.shared_network:
            self.block = moment_block(model.num_moments, self.n_model, r)
            if self.block is not None:
                model.shard_moments(*self.block, mesh)
        local = dict(model.named_parameters())
        self.items: list[_Owned] = []
        for i, name in enumerate(self.names):
            ln = self.local_name(name)
            if ln is None:
                continue                    # another rank's network
            p = local[ln]
            rows = (param_rows(p.shape, self.n_model, r)
                    if mode == "hidden" else None)
            if rows is not None:
                blk = nn.Parameter(p.detach()[rows].clone())
                self.items.append(_Owned(i, name, blk, "rows", rows))
            elif self.block is not None and network_index(name):
                self.items.append(_Owned(i, name, p, "network"))
            else:
                self.items.append(_Owned(i, name, p, "replicated"))

    # ---------------------------------------------------------------- names

    def local_name(self, name: str) -> Optional[str]:
        """The module's name of a one-process name, or None where another
        rank holds it."""
        net = network_index(name) if self.block is not None else None
        if net is None:
            return name
        lst, k, rest = net
        lo, hi = self.block
        return f"{lst}.{k - lo}.{rest}" if lo <= k < hi else None

    def describe(self) -> str:
        """What the model axis holds, and this rank's networks under
        "moments", for the Training path line and the kernel report."""
        text = model_axis_note(self.mode, self.model.shared_network,
                               self.model.num_moments, self.n_model)
        if self.block is None:
            return text
        lo, hi = self.block
        return f"{text} (networks {lo}..{hi - 1} on this rank)"

    # -------------------------------------------------------------- a step

    def params(self) -> list[torch.Tensor]:
        """The tensors this rank's optimizer steps, in the one-process
        order."""
        return [it.tensor for it in self.items]

    def _splits(self) -> list[_Owned]:
        return [it for it in self.items if it.kind == "rows"]

    def after_backward(self) -> None:
        """Each block's gradient: its rows of the whole network's (the
        gather's backward); the whole gradients are dropped."""
        local = dict(self.model.named_parameters())
        for it in self._splits():
            full = local[it.name]
            if full.grad is not None:
                it.tensor.grad = full.grad[it.rows].clone()
                full.grad = None

    def after_step(self) -> None:
        """Refill the module's whole weights from the ranks' blocks: one
        gather over the model group ("hidden"; nothing under "moments")."""
        splits = self._splits()
        if not splits:
            return
        local = dict(self.model.named_parameters())
        whole = join(self.mesh, [
            (self.full_shapes[it.name], it.tensor.dtype, it.tensor.detach(),
             it.rows) for it in splits], self.model.device)
        with torch.no_grad():
            for it, w in zip(splits, whole):
                local[it.name].copy_(w)

    # ---------------------------------------------------------- checkpoint

    def _adds(self, it: _Owned) -> bool:
        """Whether this rank adds ``it`` whole to a gather."""
        return it.kind == "network" or self.primary

    def model_state(self) -> dict:
        """The one-process state dict (collective over the model group
        under "moments"; the module's own whole networks under
        "hidden")."""
        sd = self.model.state_dict()
        if self.block is None:
            return dict(sd)
        parts = []
        for k in self.full_keys:
            ln = self.local_name(k)
            owner = ln is not None and (network_index(k) is not None
                                        or self.primary)
            parts.append((self.full_shapes[k], self.full_dtypes[k],
                          sd[ln] if owner else None, None))
        return dict(zip(self.full_keys,
                        join(self.mesh, parts, self.model.device)))

    def _template(self, state: dict) -> tuple[dict, dict]:
        """({key: per-element?}, an entry) of this rank's optimizer
        state."""
        j, st = next(iter(state.items()))
        shape = tuple(self.items[j].tensor.shape)
        return {k: torch.is_tensor(v) and v.ndim > 0
                and tuple(v.shape) == shape for k, v in st.items()}, st

    def optimizer_state(self, optimizer) -> dict:
        """The one-process optimizer state dict: every parameter's state
        gathered from the ranks that hold it (collective over the model
        group)."""
        osd = optimizer.state_dict()
        group = {k: v for k, v in osd["param_groups"][0].items()
                 if k != "params"}
        out = {"state": {}, "param_groups": [
            {**group, "params": list(range(len(self.names)))}]}
        if not osd["state"]:
            return out
        per_elem, st0 = self._template(osd["state"])
        mine = {it.index: (j, it) for j, it in enumerate(self.items)}
        parts, where = [], []
        for i, name in enumerate(self.names):
            j_it = mine.get(i)
            for key, elem in per_elem.items():
                shape = (self.full_shapes[name] if elem
                         else tuple(st0[key].shape))
                piece, rows = None, None
                if j_it is not None:
                    j, it = j_it
                    v = osd["state"][j][key]
                    if it.kind == "rows" and elem:
                        piece, rows = v, it.rows
                    elif self._adds(it):
                        piece = v
                parts.append((shape, st0[key].dtype, piece, rows))
                where.append((i, key))
        for (i, key), v in zip(where, join(self.mesh, parts,
                                           self.model.device)):
            out["state"].setdefault(i, {})[key] = v
        return out

    def pieces(self, optimizer) -> tuple[dict, dict]:
        """This rank's own part of the one-process layout, for a
        ``torch.distributed.checkpoint`` directory: whole tensors under
        their names, a row block under ``name#lo:hi``.  No collective."""
        sd = self.model.state_dict()
        model = {}
        for k in self.full_keys:
            ln = self.local_name(k)
            if ln is not None:
                model[k] = sd[ln]
        osd = optimizer.state_dict()
        group = {k: v for k, v in osd["param_groups"][0].items()
                 if k != "params"}
        state = {}
        per_elem = self._template(osd["state"])[0] if osd["state"] else {}
        for j, it in enumerate(self.items):
            tag = (f"#{it.rows.start}:{it.rows.stop}" if it.kind == "rows"
                   else "")
            if tag:
                model.pop(it.name, None)
                model[it.name + tag] = it.tensor.detach()
            if j in osd["state"]:
                state[it.index] = {
                    (key + tag if per_elem[key] else key): v
                    for key, v in osd["state"][j].items()}
        return model, {"state": state, "param_groups": [
            {**group, "params": list(range(len(self.names)))}]}

    def load(self, model_state: dict, optimizer_state: dict,
             optimizer) -> None:
        """Take this rank's part of a one-process checkpoint: the module's
        networks, the blocks, and the optimizer's state."""
        if self.block is not None:
            self.model.load_state_dict({
                self.local_name(k): v for k, v in model_state.items()
                if self.local_name(k) is not None})
        else:
            self.model.load_state_dict(model_state)
        with torch.no_grad():
            for it in self._splits():
                it.tensor.copy_(model_state[it.name][it.rows])
        group = {k: v for k, v in optimizer_state["param_groups"][0].items()
                 if k != "params"}
        state = {}
        for j, it in enumerate(self.items):
            st = optimizer_state["state"].get(it.index)
            if st is None:
                continue
            full = self.full_shapes[it.name]
            state[j] = {k: (v[it.rows] if it.kind == "rows" and torch.is_tensor(v)
                            and tuple(v.shape) == full and v.ndim > 0 else v)
                        for k, v in st.items()}
        optimizer.load_state_dict({"state": state, "param_groups": [
            {**group, "params": list(range(len(self.items)))}]})

    # ---------------------------------------------------------------- sizes

    def held_bytes(self, optimizer) -> dict:
        """Bytes this rank holds: the parameters it steps, their optimizer
        state, and the module's weights the forward reads (whole networks
        under "hidden", this rank's networks under "moments")."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)
        return {"params": nbytes(self.params()),
                "optimizer": nbytes(v for st in optimizer.state.values()
                                    for v in st.values()
                                    if torch.is_tensor(v)),
                "module": nbytes(self.model.parameters())}
