"""The (data, model) mesh over ``torch.distributed`` ranks (port of
``njode_tpu.parallel.mesh``).

A rank is one process holding one device.  The JAX package lays devices out
in a ('data', 'model') grid and lets GSPMD insert the collectives; the port
lays ranks out in the same grid (rank r at (r // M, r % M), JAX's
``devs[:n].reshape(data, model)``) and decides by hand what each rank
holds, computes and sends:

* :func:`make_mesh` — the world's ranks as a D x M grid: this rank's
  coordinates, each rank's device, and two process groups, the **data
  group** (the ranks with this rank's model coordinate: gradients are
  summed over it) and the **model group** (the ranks with this rank's data
  coordinate: they hold the same rows, and outputs and weights are gathered
  over it).
* :func:`make_batch_sharder` — keeps this rank's rows of the leading
  (trajectory) axis on the data axis, or every row where the data axis does
  not divide them (the JAX sharder replicates such arrays).  The ranks of
  one model group hold the same rows.
* :func:`shard_params` — rank 0's values broadcast into every rank; with
  ``moment_axis`` or ``hidden_axis``, what this rank keeps of them by the
  JAX package's rule (:func:`param_rows`, :func:`moment_block`).
* :func:`launch` — spawns N ranks of a function
  (``torch.multiprocessing``'s ``spawn``, a ``file://`` rendezvous) and
  returns what each rank returned.

Backends: NCCL when every rank has a card of its own, gloo when ranks share
a card or run on the CPU (:func:`choose_backend`).  Gloo on CUDA tensors
has ``all_reduce``, ``broadcast`` and ``barrier`` but no ``all_gather``;
the port's collectives on tensors are those three alone, so one code path
runs under both backends (a gather is an ``all_reduce`` of a zero-filled
buffer, :mod:`.collectives`).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

DEFAULT_TIMEOUT_S = 600.0
# the separate networks' ModuleLists of NeuralJumpODE: their stacked K axis
# is the JAX package's moment axis
NETWORK_LISTS = ("jump_nns", "ode_funcs", "output_nns")


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """Rank 0, or a process without a group: the one that writes files and
    prints."""
    return world()[0] == 0


@dataclass
class Mesh:
    """The world's ranks as a (data, model) grid.

    ``shape`` ({"data": D, "model": M}, the JAX ``Mesh.shape``), ``rank``,
    ``device`` (this rank's) and ``backend``.  ``data_group`` and
    ``model_group``: the process groups of this rank's axes; None where
    the axis spans the world (the default group) or holds this rank alone
    (:meth:`group`)."""
    shape: dict
    rank: int
    device: torch.device
    backend: str
    data_group: Any = None
    model_group: Any = None

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape["model"]

    def axis_rank(self, axis: str) -> int:
        return self.data_rank if axis == "data" else self.model_rank


def _launched_device(n: int, label: str) -> torch.device:
    """This rank's device as its launcher set it: the current card (the one
    :func:`launch` or :func:`..distributed.initialize_distributed` chose),
    or the CPU in a gloo group on a host without one."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    if (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "gloo"):
        return torch.device("cpu")
    raise ValueError(f"mesh {label} needs {n} devices, have 0")


def choose_backend(devices: Sequence, requested: Optional[str] = None
                   ) -> str:
    """NCCL when every rank has a card of its own, gloo when ranks share a
    card or any runs on the CPU.  Asking for NCCL there raises (NCCL
    refuses two ranks on one card)."""
    devs = [torch.device(d) for d in devices]
    own = (all(d.type == "cuda" for d in devs)
           and len({d.index for d in devs}) == len(devs))
    if requested is None:
        return "nccl" if own else "gloo"
    if requested == "nccl" and not own:
        raise ValueError(f"backend nccl needs a card of its own for every "
                         f"rank; the devices are {[str(d) for d in devs]} "
                         "(use gloo where ranks share a card or run on "
                         "the CPU)")
    if requested not in ("nccl", "gloo"):
        raise ValueError(f"Unknown backend: {requested!r}")
    return requested


def _axis_groups(data: int, model: int, rank: int) -> tuple:
    """(data group, model group) of ``rank`` in a data x model grid.  Every
    rank creates every group, in the same order (``dist.new_group`` is
    collective); an axis that spans the world or holds one rank needs no
    group of its own (None)."""
    if data == 1 or model == 1:
        return None, None
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return data_group, model_group


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over this world's ranks, rank r at
    (r // model, r % model).  ``data=None`` takes every rank the model axis
    leaves: max(1, ranks // model).  ``devices``, one per rank in rank
    order, may name one card twice (two ranks on one card, or on the CPU):
    the caller's request.  Without it each rank keeps the device its
    launcher set (:func:`_launched_device`).  Every rank of the world calls
    it (the axes' groups are made together)."""
    if model < 1:
        raise ValueError(f"model axis {model} < 1")
    rank, size = world()
    if data is None:
        n_dev = len(devices) if devices is not None else size
        data = max(1, n_dev // model)
    n = data * model
    if devices is not None and n > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, "
                         f"have {len(devices)}")
    if n != size:
        raise ValueError(f"mesh {data}x{model} needs a world of {n} ranks; "
                         f"this one has {size} (launch one rank a device: "
                         "parallel.launch, torchrun, or --multihost)")
    device = (torch.device(devices[rank]) if devices is not None
              else _launched_device(n, f"{data}x{model}"))
    backend = (dist.get_backend() if dist.is_available()
               and dist.is_initialized() else "none")
    data_group, model_group = _axis_groups(data, model, rank)
    return Mesh(shape={"data": data, "model": model}, rank=rank,
                device=device, backend=backend, data_group=data_group,
                model_group=model_group)


def shard_rows(mesh: Optional[Mesh], rows: int) -> Optional[slice]:
    """This rank's rows of a leading axis of ``rows``: a contiguous block
    where the data axis divides it (the JAX ``P('data')`` layout), else
    None (every rank holds every row)."""
    if mesh is None or mesh.n_data <= 1 or rows % mesh.n_data:
        return None
    per = rows // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def make_batch_sharder(mesh: Mesh) -> Callable:
    """``shard(*arrays)``: each array's rows of this rank on the leading
    (trajectory) axis; an array whose rows the data axis does not divide is
    kept whole (``njode_tpu/parallel/mesh.py:66-83``)."""

    def shard(*arrays):
        out = []
        for a in arrays:
            sl = shard_rows(mesh, a.shape[0])
            out.append(a if sl is None else a[sl])
        return tuple(out) if len(out) > 1 else out[0]

    return shard


def moment_block(num_moments: int, n_model: int, model_rank: int
                 ) -> Optional[tuple[int, int]]:
    """(lo, hi): the separate networks this model rank holds, a contiguous
    block of K / M, where the model axis divides K > 1 (JAX's
    ``moment_axis`` rule on the stacked K axis); None: every rank holds
    all K."""
    if n_model <= 1 or num_moments <= 1 or num_moments % n_model:
        return None
    per = num_moments // n_model
    return model_rank * per, (model_rank + 1) * per


def param_rows(shape, n_model: int, model_rank: int) -> Optional[slice]:
    """This model rank's rows of a weight or bias under ``hidden_axis``:
    torch's leading axis is the output features, JAX's trailing one, cut in
    contiguous blocks where M divides it and it is longer than 1 (an output
    head that does not divide stays whole); None: replicated."""
    if n_model <= 1 or len(shape) < 1 or shape[0] <= 1 or shape[0] % n_model:
        return None
    per = shape[0] // n_model
    return slice(model_rank * per, (model_rank + 1) * per)


def network_index(name: str) -> Optional[tuple[str, int, str]]:
    """(list, k, rest) of a separate network's parameter name
    ("jump_nns.1.net.0.weight" -> ("jump_nns", 1, "net.0.weight")), or
    None for a shared network's."""
    head, _, tail = name.partition(".")
    if head not in NETWORK_LISTS:
        return None
    k, _, rest = tail.partition(".")
    return head, int(k), rest


def _broadcast(params) -> None:
    """Rank 0's values of a module's state, a dict's or a tensor's, into
    every rank's tensors in place."""
    if world()[1] <= 1:
        return
    if isinstance(params, torch.nn.Module):
        tensors = list(params.state_dict().values())
    elif isinstance(params, dict):
        tensors = list(params.values())
    else:
        tensors = [params]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)


def shard_params(mesh: Mesh, params, moment_axis: bool = False,
                 hidden_axis: bool = False):
    """Place ``params`` (a module, a state dict or a tensor) on the mesh
    (``njode_tpu/parallel/mesh.py:86-108``): rank 0's values are broadcast
    into every rank's tensors in place, then this rank keeps its part.

    * No axis: everything is replicated; returns ``params``.
    * ``moment_axis``: a separate network's tensors (K networks, the JAX
      stacked K axis) stay on the model rank of its block of K / M
      (:func:`moment_block`); a state dict comes back with the keys of this
      rank's networks and every other key, a module as a
      :class:`~.model_axis.ModelShard` holding its networks alone.  A
      shared network has no moment axis: it stays whole on every rank.
    * ``hidden_axis``: every weight and bias whose output width M divides
      is cut to this rank's rows (:func:`param_rows`); a state dict or a
      tensor comes back cut, a module as a ``ModelShard`` that holds the
      blocks (the module keeps whole networks for the forward).
    * Anything neither rule takes is replicated.
    """
    if moment_axis and hidden_axis:
        raise ValueError("shard_params: moment_axis or hidden_axis, not both")
    _broadcast(params)
    if not (moment_axis or hidden_axis):
        return params
    if isinstance(params, torch.nn.Module):
        from .model_axis import ModelShard
        return ModelShard(mesh, params,
                          "moments" if moment_axis else "hidden")
    M, r = mesh.n_model, mesh.model_rank
    if torch.is_tensor(params):
        rows = param_rows(params.shape, M, r) if hidden_axis else None
        return params if rows is None else params[rows]
    out = {}
    n_nets = 1 + max([network_index(k)[1] for k in params
                      if network_index(k) is not None], default=-1)
    block = moment_block(n_nets, M, r) if moment_axis else None
    for k, v in params.items():
        net = network_index(k)
        if block is not None and net is not None:
            if block[0] <= net[1] < block[1]:
                out[k] = v
            continue
        rows = param_rows(v.shape, M, r) if hidden_axis else None
        out[k] = v if rows is None else v[rows]
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over ``group`` (None: the world), in place, through
    one flat buffer (one collective)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def barrier() -> None:
    """Every rank waits here; nothing without a group."""
    if world()[1] > 1:
        dist.barrier()


# --------------------------------------------------------------------------
# launch
# --------------------------------------------------------------------------

def _rank_main(rank: int, fn, args, size: int, devices: list, backend: str,
               workdir: str) -> None:
    """One spawned rank: its device, the group, ``fn(*args)``, and its
    result saved for the parent (or its traceback)."""
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "rdv"),
        world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    try:
        out = fn(*args)
        dist.barrier()
    except BaseException:
        # before the group closes: the other ranks fail after this one
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"result_{rank}.pt"))


def launch(fn: Callable, n_ranks: int, args: tuple = (),
           devices: Optional[Sequence] = None,
           backend: Optional[str] = None,
           timeout: Optional[float] = None) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` spawned ranks, one device each
    (``devices``, by rank; default ``cuda:0..N-1``), in one process group
    (``backend``: :func:`choose_backend`'s), and return each rank's result
    in rank order.  ``fn`` must be importable by name (a module's
    function).  A rank that fails fails the call with its traceback, the
    others killed.  The ranks run as long as they need; a collective that
    hangs fails after ``DEFAULT_TIMEOUT_S``.  ``timeout`` (the tests' and
    the chip smoke's) also bounds the world's wall time: past it the ranks
    are killed and ``TimeoutError`` raised."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < n_ranks:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise ValueError(f"mesh {n_ranks}x1 needs {n_ranks} devices, "
                             f"have {have}")
        devices = [f"cuda:{r}" for r in range(n_ranks)]
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != n_ranks:
        raise ValueError(f"{len(devices)} devices for {n_ranks} ranks")
    backend = choose_backend(devices, backend)
    what = (f"{n_ranks} ranks of {getattr(fn, '__name__', fn)} over "
            f"{backend} on {devices}")
    workdir = tempfile.mkdtemp(prefix="njode_ranks_")
    ctx = mp.start_processes(
        _rank_main, args=(fn, args, n_ranks, devices, backend, workdir),
        nprocs=n_ranks, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(
                    f"{what}: not finished within {timeout:g} s; killed "
                    f"(exit codes {[p.exitcode for p in ctx.processes]})")
        return [torch.load(os.path.join(workdir, f"result_{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]
    except ProcessException as e:
        errors = []
        for r in range(n_ranks):
            path = os.path.join(workdir, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        raise RuntimeError(f"{what}: " + ("\n".join(errors) or str(e))
                           ) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)
