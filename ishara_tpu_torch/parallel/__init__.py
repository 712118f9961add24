"""Data parallelism over a device mesh (port of ``ishara_tpu/parallel/``,
without its 2-D tensor-parallel rules): meshes and batch placements
(:mod:`.mesh`), multi-process set-up and feeding (:mod:`.distributed`),
and the batch shard the layers read (:mod:`.shard`)."""

from .distributed import (
    host_local_to_global,
    initialize_distributed,
    process_shard,
)
from .mesh import (
    DATA_AXIS,
    DCN_AXIS,
    batch_shard_of,
    batch_sharding,
    make_mesh,
    make_multislice_mesh,
    multislice_batch_sharding,
    replicated,
    shard_batch,
)
from .shard import BatchShard, batch_shard, current_shard

__all__ = [
    "BatchShard",
    "DATA_AXIS",
    "DCN_AXIS",
    "batch_shard",
    "batch_shard_of",
    "batch_sharding",
    "current_shard",
    "host_local_to_global",
    "initialize_distributed",
    "make_mesh",
    "make_multislice_mesh",
    "multislice_batch_sharding",
    "process_shard",
    "replicated",
    "shard_batch",
]
