"""Data and tensor parallelism over a device mesh (port of
``ishara_tpu/parallel/``): meshes and batch placements (:mod:`.mesh`),
multi-process set-up and feeding (:mod:`.distributed`), the batch shard the
layers read (:mod:`.shard`), and the tensor-parallel rules and operators
over a ``(data, model)`` mesh (:mod:`.tp`)."""

from .distributed import (
    host_local_to_global,
    initialize_distributed,
    process_shard,
)
from .mesh import (
    DATA_AXIS,
    DCN_AXIS,
    MODEL_AXIS,
    batch_shard_of,
    batch_sharding,
    make_mesh,
    make_multislice_mesh,
    multislice_batch_sharding,
    replicated,
    row_shards,
    shard_batch,
)
from .shard import BatchShard, ModelAxis, batch_shard, current_shard
from .tp import (
    gather_params_tp,
    make_2d_mesh,
    shard_state_tp,
    tp_param_shardings,
)

__all__ = [
    "BatchShard",
    "DATA_AXIS",
    "DCN_AXIS",
    "MODEL_AXIS",
    "ModelAxis",
    "batch_shard",
    "batch_shard_of",
    "batch_sharding",
    "current_shard",
    "gather_params_tp",
    "host_local_to_global",
    "initialize_distributed",
    "make_2d_mesh",
    "make_mesh",
    "make_multislice_mesh",
    "multislice_batch_sharding",
    "process_shard",
    "replicated",
    "row_shards",
    "shard_batch",
    "shard_state_tp",
    "tp_param_shardings",
]
