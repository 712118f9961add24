"""Device meshes and batch placements (port of ``ishara_tpu/parallel/
mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
process group, one process a card: the counterpart of ``jax.sharding.Mesh``.
Data parallelism is a 1-D ``data`` mesh, or a 2-D ``(dcn, data)`` one whose
rows are hosts, so that the gradient's all-reduce runs within a host first
and across hosts once. The placements returned by :func:`batch_sharding`,
:func:`multislice_batch_sharding` and :func:`replicated` are DTensor
placements, the counterpart of a ``NamedSharding``'s ``PartitionSpec``;
:func:`shard_batch` distributes a batch with them.
"""

from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist

from .shard import BatchShard

DATA_AXIS = "data"
DCN_AXIS = "dcn"


def _ensure_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() "
                           "(or torch.distributed.init_process_group) first")


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(num_devices: int = -1, axis: str = DATA_AXIS):
    """A 1-D mesh named ``axis`` over the first ``num_devices`` processes
    of the group (all of them by default)."""
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_group()
    world = dist.get_world_size()
    n = world if num_devices in (-1, None) else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"{n} devices asked for, {world} processes")
    return DeviceMesh(_device_type(), torch.arange(n), mesh_dim_names=(axis,))


def _hosts(ranks: list[int]) -> list[str]:
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return [names[r] for r in ranks]


def make_multislice_mesh(num_slices: int = -1, devices=None,
                         axes: tuple[str, str] = (DCN_AXIS, DATA_AXIS)):
    """A 2-D ``(dcn, data)`` mesh for data parallelism over several hosts.

    On a group that spans hosts the rows are the hosts (each row cut to the
    smallest host's process count), so the gradient's sum runs over the
    fast links within a host and then once across hosts. Where every
    process is on one host the ranks are split in order into
    ``num_slices`` equal rows. ``devices``: the ranks to use (default all).
    Raises ValueError without ``num_slices`` on one host, and with more
    slices than ranks."""
    if devices is None:
        devices = list(range(dist.get_world_size())) \
            if dist.is_initialized() else [0]
    devices = [int(d) for d in devices]
    hosts = _hosts(devices) if dist.is_initialized() \
        and dist.get_world_size() > 1 else ["localhost"] * len(devices)
    names = list(dict.fromkeys(hosts))
    if len(names) > 1:
        rows = [[d for d, h in zip(devices, hosts) if h == n] for n in names]
        if num_slices not in (-1, None) and num_slices != len(rows):
            raise ValueError(f"{len(rows)} hosts in the group, asked for "
                             f"{num_slices} slices")
        width = min(len(r) for r in rows)
        grid = [r[:width] for r in rows]
    else:
        if num_slices in (-1, None):
            raise ValueError("num_slices required when the group runs on "
                             "one host")
        per = len(devices) // num_slices
        if per == 0:
            raise ValueError(f"{len(devices)} devices < {num_slices} slices")
        grid = [devices[i * per:(i + 1) * per] for i in range(num_slices)]
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_group()
    return DeviceMesh(_device_type(), torch.tensor(grid),
                      mesh_dim_names=tuple(axes))


def _axes(mesh, axis) -> tuple[str, ...]:
    names = mesh.mesh_dim_names
    if axis is None:
        return tuple(names)
    return (axis,) if isinstance(axis, str) else tuple(axis)


def batch_sharding(mesh, axis=DATA_AXIS) -> list:
    """Placements that shard the leading (batch) dim over ``axis`` (a name
    or a tuple of names) and replicate over the mesh's other axes."""
    from torch.distributed.tensor import Replicate, Shard

    over = _axes(mesh, axis)
    return [Shard(0) if n in over else Replicate()
            for n in mesh.mesh_dim_names]


def multislice_batch_sharding(mesh) -> list:
    """The batch dim sharded over every mesh axis: each process holds
    ``B / mesh.size()`` rows, host-major."""
    return batch_sharding(mesh, None)


def replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def shard_batch(batch, mesh, axis=DATA_AXIS):
    """A dict of ``[B, ...]`` tensors (the same on every process) as
    DTensors with the batch sharded over ``axis``; other entries pass."""
    from torch.distributed.tensor import distribute_tensor

    placements = batch_sharding(mesh, axis)
    return {k: distribute_tensor(torch.as_tensor(v), mesh, placements)
            if isinstance(v, (torch.Tensor, np.ndarray)) else v
            for k, v in batch.items()}


def batch_shard_of(mesh, local_rows: int) -> BatchShard:
    """This process's :class:`~.shard.BatchShard` of a batch sharded over
    every axis of ``mesh`` (host-major), ``local_rows`` rows a process:
    its first row, the global batch, and the mesh's groups innermost first
    (``data``, then ``dcn``), the order the sums run in."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not in the mesh")
    flat = 0
    for c, n in zip(coord, mesh.shape):
        flat = flat * n + c
    groups = tuple(mesh.get_group(d) for d in reversed(range(mesh.ndim)))
    return BatchShard(row0=flat * local_rows, local=local_rows,
                      rows=local_rows * mesh.size(), groups=groups)
