"""Which rows of the global batch this process holds, for the layers whose
result depends on the whole batch.

Under data parallelism every process runs the same step on its own rows of
one global batch of ``B`` rows. Three things in the model must still see
the global batch, so that the step computes what the unsharded step
computes on all ``B`` rows:

* **BatchNorm** takes its training statistics over every row: the layer
  sums ``x`` and ``x**2`` over its own rows and adds the sums of all the
  processes with :func:`sum_over_shards`, an all-reduce that is also one in
  the backward pass;
* **dropout** masks are indexed by an element's flat position in the
  global tensor: a process whose first row is ``row0`` offsets its masks by
  :func:`element_offset`;
* **kernel selection** (:mod:`ishara_tpu_torch.ops.selection`) is keyed on
  the global batch, :func:`global_batch`.

The step says which rows it holds with :func:`batch_shard` around its
forward *and* backward pass; outside it (the default) the local batch is
the whole batch. The setting is a module global rather than a thread-local
one, because the autograd engine runs a CUDA backward pass -- and with it
the recomputation of ``remat`` blocks -- on threads of its own.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class BatchShard:
    """``rows`` ``[row0, row0 + local)`` of a batch of ``rows`` rows;
    summing over each process group of ``groups`` in turn sums over every
    process that holds a shard of it."""

    row0: int = 0
    local: int | None = None
    rows: int | None = None
    groups: tuple = ()


_WHOLE = BatchShard()
_current = _WHOLE


def current_shard() -> BatchShard:
    return _current


@contextlib.contextmanager
def batch_shard(shard: BatchShard | None):
    """Within the block the layers compute as for ``shard`` (``None``: the
    local batch is the whole batch)."""
    global _current
    saved = _current
    _current = _WHOLE if shard is None else shard
    try:
        yield _current
    finally:
        _current = saved


def global_batch(x: torch.Tensor) -> int:
    """The batch size of the step ``x`` (``[B_local, ...]``) belongs to."""
    return _current.rows if _current.rows is not None else x.shape[0]


def element_offset(x: torch.Tensor) -> int:
    """The flat index, in the global tensor, of ``x``'s first element: ``x``
    leads with this process's rows (a dropout site laid out otherwise would
    need another formula, so it raises)."""
    sh = _current
    if sh.local is None:
        return 0
    if x.shape[0] != sh.local:
        raise ValueError(
            f"a dropout site's tensor must lead with the batch's "
            f"{sh.local} rows, got shape {tuple(x.shape)}")
    return sh.row0 * (x.numel() // x.shape[0])


def reduce_sum_(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed in place over every group of ``groups`` in turn."""
    for g in groups:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return t


class _SumOverShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return reduce_sum_(t.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        # every process's loss depends on the sum: its gradient is the sum
        # of theirs
        return reduce_sum_(g.contiguous().clone(), ctx.groups), None


def sum_over_shards(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes of the current shard (``t`` itself
    outside one), differentiably."""
    groups = _current.groups
    if not groups:
        return t
    return _SumOverShards.apply(t, groups)


def gather_rows(t: torch.Tensor, shard: BatchShard) -> torch.Tensor:
    """The global ``[B, ...]`` tensor whose rows ``[row0, row0 + local)``
    are each process's ``t``: zeros elsewhere summed over the shard's
    groups, so the backend needs nothing but an all-reduce (gloo reduces
    CUDA tensors but does not gather them). Exact: a value plus zeros is the
    value."""
    if not shard.groups:
        return t
    out = t.new_zeros((shard.rows,) + tuple(t.shape[1:]))
    out[shard.row0:shard.row0 + shard.local] = t
    return reduce_sum_(out, shard.groups)

