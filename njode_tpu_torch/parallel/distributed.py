"""Multi-host initialization (port of ``njode_tpu.parallel.distributed``).

Multi-host training is one program over every rank of every host: call
:func:`initialize_distributed` once in each process before making a mesh,
and :func:`global_mesh` then spans all hosts.  The JAX package asks
``jax.distributed`` to find its cluster; the port reads the launcher's
environment itself: torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT``, or SLURM's ``SLURM_PROCID`` /
``SLURM_NTASKS`` / ``SLURM_LOCALID`` beside ``MASTER_ADDR`` /
``MASTER_PORT``.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT_S, choose_backend, make_mesh


def _env_int(name: str) -> Optional[int]:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return None


def _launcher_env() -> Optional[tuple[str, int, int, int]]:
    """(init method, world size, rank, local rank) from torchrun's
    environment (``env://``, which also finds torchrun's own store) or
    SLURM's (``tcp://`` to ``MASTER_ADDR``), or None."""
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not (addr and port):
        return None
    size, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    if size is not None and rank is not None:
        local = _env_int("LOCAL_RANK")
        return "env://", size, rank, rank if local is None else local
    size, rank = _env_int("SLURM_NTASKS"), _env_int("SLURM_PROCID")
    if size is None or rank is None:
        return None
    local = _env_int("SLURM_LOCALID")
    return (f"tcp://{addr}:{port}", size, rank,
            rank if local is None else local)


def _looks_multihost() -> bool:
    """The environment of a job with several processes
    (``njode_tpu/parallel/distributed.py:64-75``, with torchrun's
    ``WORLD_SIZE``)."""
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Join the process group (idempotent: a second call returns the rank).

    Explicit arguments (``host:port`` of process 0, the process count, this
    process's id) take a ``tcp://`` rendezvous; without them the launcher's
    environment does.  With neither, a single process runs on with one
    note, unless the environment looks multi-host, where that would train
    independent models each believing it is rank 0: then it raises.  Each
    process takes card ``LOCAL_RANK`` (else its rank modulo the cards) and
    NCCL; a host without a card takes gloo on the CPU.  Returns the rank."""
    if dist.is_initialized():
        return dist.get_rank()
    explicit = (coordinator_address is not None or process_id is not None
                or (num_processes is not None and num_processes > 1))
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "initialize_distributed: --coordinator-address, "
                "--num-processes and --process-id go together (got "
                f"{coordinator_address!r}, {num_processes!r}, "
                f"{process_id!r})")
        init, size, rank = (f"tcp://{coordinator_address}",
                            int(num_processes), int(process_id))
        local = _env_int("LOCAL_RANK")
        local = rank if local is None else local
    else:
        env = _launcher_env()
        if env is None:
            if _looks_multihost():
                raise RuntimeError(
                    "initialize_distributed: the environment looks multi-"
                    "host (WORLD_SIZE / SLURM_NTASKS / OMPI_COMM_WORLD_SIZE "
                    "> 1) but names no rendezvous (MASTER_ADDR and "
                    "MASTER_PORT, with RANK or SLURM_PROCID); every process "
                    "would train alone as rank 0")
            print("initialize_distributed: single-process mode (no launcher "
                  "environment and no coordinator address)", file=sys.stderr)
            return 0
        init, size, rank, local = env
    if torch.cuda.is_available():
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = choose_backend([device])
    dist.init_process_group(
        backend, init_method=init, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    print(f"initialize_distributed: rank {rank} of {size}, backend "
          f"{backend}, device {device}", flush=True)
    return rank


def global_mesh(model: int = 1):
    """A ('data', 'model') mesh over every rank of every host."""
    return make_mesh(model=model)
