"""Parallelism over ``torch.distributed`` ranks: the (data, model) mesh,
data parallelism, the model axis and multi-host initialization (port of
``njode_tpu.parallel``).  ``batch_spec`` (a JAX ``PartitionSpec``) has no
torch meaning."""

from .distributed import global_mesh, initialize_distributed
from .mesh import (Mesh, all_reduce_sum, choose_backend, is_primary, launch,
                   make_batch_sharder, make_mesh, shard_params)
from .model_axis import ModelShard

__all__ = ["Mesh", "ModelShard", "all_reduce_sum", "choose_backend",
           "global_mesh", "initialize_distributed", "is_primary", "launch",
           "make_batch_sharder", "make_mesh", "shard_params"]
