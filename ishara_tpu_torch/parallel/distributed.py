"""Multi-process initialization and data feeding (port of ``ishara_tpu/
parallel/distributed.py``).

One process a card, as ``torchrun`` starts them:

* :func:`initialize_distributed` -- an idempotent wrapper around
  ``torch.distributed.init_process_group`` that resolves the coordinator
  from its arguments, then ``ISHARA_COORDINATOR`` / ``ISHARA_NUM_PROCESSES``
  / ``ISHARA_PROCESS_ID``, then torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``
  / ``WORLD_SIZE`` / ``RANK`` (the counterpart of JAX's pod auto-detection);
* :func:`process_shard` -- (rank, world size) for sharding the corpus per
  process (``ParquetASLFR(process_index=..., process_count=...)``);
* :func:`host_local_to_global` -- each process's rows as one DTensor of the
  global batch, without moving any host data between processes.

In a single process every function degrades to a no-op or an identity.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> bool:
    """Join the process group when a multi-process run is configured;
    returns True when running multi-process.

    ``coordinator_address`` is ``host:port`` of rank 0. The group is NCCL
    when a card is visible, with the process on card ``LOCAL_RANK`` (else
    its rank modulo the cards), and gloo otherwise.
    Safe to call again and in a single process, where it returns False and
    starts nothing."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address \
        or os.environ.get("ISHARA_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("ISHARA_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("ISHARA_PROCESS_ID")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
        if num_processes is None:
            num_processes = _env_int("WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("RANK")
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "address, the number of processes and this "
                         "process's id")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_world_size() > 1


def process_shard() -> tuple[int, int]:
    """(rank, world size); (0, 1) in a single process."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_local_to_global(batch: dict, mesh, axis=None) -> dict:
    """Each process's rows ``[B_local, ...]`` -> one DTensor ``[B, ...]``
    with the batch sharded over ``axis`` of ``mesh`` (default: every axis
    but ``model``, host-major). In a single process this is
    :func:`~ishara_tpu_torch.parallel.mesh.shard_batch`. Entries that are
    not tensors or arrays pass as they are."""
    from torch.distributed.tensor import DTensor

    from .mesh import batch_sharding, shard_batch

    if mesh.size() == 1:
        return shard_batch(batch, mesh, axis)
    placements = batch_sharding(mesh, axis)
    out = {}
    for k, v in batch.items():
        if isinstance(v, (torch.Tensor, np.ndarray)):
            out[k] = DTensor.from_local(torch.as_tensor(v), mesh, placements,
                                        run_check=False)
        else:
            out[k] = v
    return out
