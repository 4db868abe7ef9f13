"""Parallelism over ``torch.distributed`` ranks: the (data, model) mesh,
data parallelism and multi-host initialization (port of
``njode_tpu.parallel``; the model axis is ROADMAP.md Queue 1 item 12b).
``batch_spec`` (a JAX ``PartitionSpec``) has no torch meaning."""

from .distributed import global_mesh, initialize_distributed
from .mesh import (Mesh, choose_backend, is_primary, launch,
                   make_batch_sharder, make_mesh, shard_params)

__all__ = ["Mesh", "choose_backend", "global_mesh", "initialize_distributed",
           "is_primary", "launch", "make_batch_sharder", "make_mesh",
           "shard_params"]
