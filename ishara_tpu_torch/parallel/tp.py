"""Tensor parallelism over a 2-D ``(data, model)`` mesh (port of
``ishara_tpu/parallel/tp.py``).

**The rules** are the reference's, on the flax path of each parameter
(:mod:`ishara_tpu_torch.bridge` names it): the attention's QKV / Q / K / V
kernels and the block FFNs' expand kernel and bias are *column-parallel*,
sharded on their output features over ``model``; the projection and the
FFNs' contract kernel are *row-parallel*, sharded on their input features.
A torch ``weight`` is ``[out, in]``, so column-parallel is its dim 0 (and a
bias's) and row-parallel its dim 1. Every other leaf is replicated, and so
is a ruled leaf whose sharded dim does not divide the ``model`` axis.

**The products.** The reference's GSPMD partitions the unchanged step. Here
:func:`shard_state_tp` keeps each ruled leaf as this process's slice, and
the layers run Megatron's pair of operators where a block's pair of
products is split the same way (the self-attention's QKV and projection
with whole heads a process, the block FFN's expand and contract):
:func:`copy_to_model` (identity forward, all-reduce backward) at the
column-parallel input and :func:`reduce_from_model` (all-reduce forward,
identity backward) at the row-parallel output, so a block takes one
reduction a product pair forward and one backward, where the reference's
docstring puts them. Any other sharded leaf (a slice that is not whole
heads, a partner replicated by the divisibility rule, the translation
model's attention and feed-forward leaves) is gathered over ``model`` for
the compute (:func:`gathered_weights`): the storage follows the rules, the
result does not change.

**What stays global.** The batch's rows are sharded over ``data`` only
(:func:`~.mesh.batch_shard_of`), so BatchNorm's sums and the gradient's
mean run over ``data``; the global norm adds the replicated leaves once
and the sharded ones summed over ``model`` (:func:`tp_global_norm`); a
dropout site on a slice draws the unsharded step's mask at its global
positions (:func:`~.shard.split_offset`). Replicas along ``model`` keep
their replicated leaves bit for bit.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, _device_type, _ensure_group
from .shard import ModelAxis, current_shard

# (regex on the flax path, torch dim sharded over ``model`` by leaf ndim)
_TP_RULES: list[tuple[str, dict[int, int]]] = [
    # column-parallel: output features sharded
    (r"(^|/)(qkv|sa_q|sa_k|sa_v|ca_q|ca_k|ca_v|q|k|v)/kernel", {2: 0}),
    (r"(ffn\d?|ff1|ff2)/fc1/kernel", {2: 0}),
    (r"(ffn\d?|ff1|ff2)/fc1/bias", {1: 0}),
    # row-parallel: input features sharded (reduced at the output)
    (r"(^|/)(proj|sa_out|ca_out|out)/kernel", {2: 1}),
    (r"(ffn\d?|ff1|ff2)/fc2/kernel", {2: 1}),
]


def flax_path(name: str, ndim: int) -> str:
    """The flax path of the port's parameter ``name`` (``squeezeformer.0.
    mha.qkv.weight`` -> ``squeezeformer_0/mha/qkv/kernel``)."""
    from ..bridge import _LEAF_BACK, _flax_module_name

    *path, leaf = name.split(".")
    leaf = "kernel" if leaf == "weight" and ndim >= 2 else _LEAF_BACK[leaf]
    return "/".join(_flax_module_name(path) + [leaf])


def tp_dim(name: str, shape, parts: int) -> int | None:
    """The dim of parameter ``name`` (of ``shape``) sharded over a ``model``
    axis of ``parts`` processes, or None (replicated)."""
    path = flax_path(name, len(shape))
    for pat, by_ndim in _TP_RULES:
        if re.search(pat, path):
            dim = by_ndim.get(len(shape))
            if dim is not None and shape[dim] % parts == 0:
                return dim
    return None


def model_parts(mesh) -> int:
    """The size of ``mesh``'s ``model`` axis (1 without one); an int is
    taken as that size."""
    if isinstance(mesh, int):
        return mesh
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(MODEL_AXIS)] if MODEL_AXIS in names else 1


def tp_param_shardings(model: torch.nn.Module, mesh) -> dict[str, int | None]:
    """For each parameter of ``model`` (its full, unsharded shapes), the
    dim it is sharded on over ``mesh``'s ``model`` axis, or None. ``mesh``
    may be the axis's size."""
    parts = model_parts(mesh)
    return {name: tp_dim(name, tuple(p.shape), parts)
            for name, p in model.named_parameters()}


def make_2d_mesh(data: int, model: int):
    """A ``(data, model)`` ``DeviceMesh`` over the first ``data * model``
    processes of the group: rank ``d * model + m`` at ``(d, m)``, the order
    of the reference's ``devices.reshape(data, model)``."""
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_group()
    world = dist.get_world_size()
    if not 1 <= data * model <= world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"processes, the group has {world}")
    return DeviceMesh(_device_type(), torch.arange(data * model)
                      .reshape(data, model),
                      mesh_dim_names=("data", MODEL_AXIS))


# ---------------------------------------------------------------------------
# Megatron's operators over the model axis
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in float32, in ``t``'s dtype (a new
    tensor)."""
    buf = t.to(torch.float32).contiguous().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # each process's slice of the next product took x: its gradient is
        # the sum of theirs
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(local: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """Each process's ``local`` slice along ``dim`` put together: zeros
    elsewhere summed over the axis (exact: a value plus zeros is the
    value), so the backend needs nothing but an all-reduce (gloo reduces
    CUDA tensors but does not gather them)."""
    n = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * axis.size
    full = local.new_zeros(shape)
    full.narrow(dim, axis.rank * n, n).copy_(local)
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=axis.group)
    return full


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, dim, axis: ModelAxis):
        n = local.shape[dim]
        ctx.dim, ctx.at, ctx.n = dim, axis.rank * n, n
        return _gather(local, dim, axis)

    @staticmethod
    def backward(ctx, g):
        # every process computed the same full gradient: its slice is ours
        return g.narrow(ctx.dim, ctx.at, ctx.n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` at a column-parallel product's input: the identity forward, an
    all-reduce over ``model`` backward."""
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """A row-parallel product's partial sums summed over ``model`` (in
    float32, in ``x``'s dtype); the identity backward."""
    return _ReduceFromModel.apply(x, axis.group)


def gather_from_model(local: torch.Tensor, dim: int,
                      axis: ModelAxis) -> torch.Tensor:
    """The full leaf from each process's slice along ``dim``; the backward
    keeps this process's slice of the gradient."""
    return _GatherFromModel.apply(local, dim, axis)


def model_axis(parts: int) -> ModelAxis | None:
    """The current shard's ``model`` axis for a layer that holds slices of
    ``parts`` (None when ``parts`` is 1); raises outside a step on a
    ``(data, model)`` mesh of that size."""
    if parts == 1:
        return None
    axis = current_shard().model
    if axis is None or axis.size != parts:
        raise ValueError(
            f"a layer sharded over {parts} model processes runs only in a "
            f"step given its (data, model) mesh (the steps' mesh=)")
    return axis


# ---------------------------------------------------------------------------
# The train state on the mesh
# ---------------------------------------------------------------------------

@dataclass
class TPLayout:
    """How a ``TrainState`` is laid out over the ``model`` axis: the
    sharded parameters and their dims, and which elements of the flat
    parameter tensor are slices (``sharded``, bool)."""

    group: object
    rank: int
    size: int
    dims: dict[str, int]
    sharded: torch.Tensor


def _local_modules(model, dims: dict[str, int], parts: int) -> set[str]:
    """The modules that run their products on their own slices: a
    self-attention with its QKV sharded on dim 0, its projection on dim 1
    and whole heads a process; a block FFN with its expand weight and bias
    on dim 0 and its contract weight on dim 1."""
    from ..models.layers import FusedFFN, MultiHeadSelfAttention

    out = set()
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, MultiHeadSelfAttention):
            want = {"qkv.weight": 0, "proj.weight": 1}
            ok = mod.num_heads % parts == 0
        elif isinstance(mod, FusedFFN):
            want = {"fc1.weight": 0, "fc1.bias": 0, "fc2.weight": 1}
            ok = True
        else:
            continue
        if ok and all(dims.get(pre + k) == d for k, d in want.items()):
            out.add(name)
    return out


def shard_state_tp(state, mesh):
    """Place ``state`` (a ``TrainState``, the same on every process) on a
    ``(data, model)`` mesh, in place: each parameter the rules shard is
    kept as this process's slice in the fast parameters, the Lookahead
    slow parameters and the optimizer's moments; everything else stays
    replicated. The attention and FFN modules whose pair of products is
    split take their slices' path; the other sharded leaves are gathered
    for the compute. Returns ``state``; step it with ``mesh=``."""
    from ..train.state import _flatten_parameters

    if getattr(state, "tp", None) is not None:
        raise ValueError("the state is already sharded")
    names = mesh.mesh_dim_names or ()
    if MODEL_AXIS not in names:
        raise ValueError(f"a tensor-parallel mesh has a {MODEL_AXIS!r} "
                         f"axis, got {names}")
    d = names.index(MODEL_AXIS)
    parts, rank = mesh.shape[d], mesh.get_coordinate()[d]
    model = state.model
    dims = {n: k for n, k in tp_param_shardings(model, parts).items()
            if k is not None}
    local = _local_modules(model, dims, parts)
    old = {name: (state.slices[name], tuple(p.shape))
           for name, p in model.named_parameters()}

    def cut(t, name):
        dim = dims[name]
        n = t.shape[dim] // parts
        return t.narrow(dim, rank * n, n).contiguous()

    gather = []
    for name in dims:
        mod_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = model.get_submodule(mod_name)
        mod._parameters[leaf].data = cut(mod._parameters[leaf].data, name)
        if mod_name.rsplit(".", 1)[0] not in local:
            gather.append((mod_name, leaf, dims[name]))
    for name in local:
        model.get_submodule(name).tp_parts = parts
    model.tp_gather = tuple(gather)

    params, slices = _flatten_parameters(model)

    def relay(flat):
        return torch.cat([
            (cut(flat[sl].view(shape), name) if name in dims
             else flat[sl].view(shape)).reshape(-1)
            for name, (sl, shape) in old.items()])

    n_old = state.params.numel()
    state.slow_params = relay(state.slow_params)
    state.opt_state = {k: relay(v) if v.dim() == 1 and v.numel() == n_old
                       else v for k, v in state.opt_state.items()}
    state.params, state.slices = params, slices
    sharded = torch.zeros(params.numel(), dtype=torch.bool,
                          device=params.device)
    for name in dims:
        sharded[slices[name]] = True
    state.tp = TPLayout(mesh.get_group(d), rank, parts, dims, sharded)
    return state


@contextlib.contextmanager
def gathered_weights(model: torch.nn.Module):
    """Within the block ``model`` computes with the full value of each
    sharded leaf that no module computes on in slices (gathered over
    ``model``; the gradient reaches the slice). Nothing without such
    leaves. Keep the backward pass inside the block when blocks are
    recomputed (``remat``)."""
    plan = getattr(model, "tp_gather", ())
    if not plan:
        yield
        return
    axis = current_shard().model
    if axis is None:
        raise ValueError("a tensor-parallel state runs only in a step "
                         "given its (data, model) mesh (the steps' mesh=)")
    swapped = []
    try:
        for mod_name, leaf, dim in plan:
            mod = model.get_submodule(mod_name)
            p = mod._parameters[leaf]
            swapped.append((mod, leaf, p))
            mod._parameters[leaf] = gather_from_model(p, dim, axis)
        yield
    finally:
        for mod, leaf, p in swapped:
            mod._parameters[leaf] = p


def tp_global_norm(flat: torch.Tensor, layout: TPLayout) -> torch.Tensor:
    """The 2-norm of the whole (unsharded) parameter set's ``flat`` vector
    laid out as ``layout``: the replicated elements once, the slices'
    squares summed over ``model``. Each part is ``torch.sum`` over the
    whole vector, as ``train.optim.global_norm`` takes it, with the other
    part's squares zeroed (no boolean indexing: no sync with the host)."""
    sq = flat * flat
    zero = sq.new_zeros(())
    part = torch.sum(torch.where(layout.sharded, sq, zero)).reshape(1)
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=layout.group)
    return torch.sqrt(torch.sum(torch.where(layout.sharded, zero, sq))
                      + part[0])


def gather_params_tp(state, flat=None) -> dict[str, torch.Tensor]:
    """Every parameter of a sharded ``state`` at its full shape, by name
    (slices gathered over ``model``), on every process; ``flat``: another
    tensor laid out as ``state.params`` (the slow parameters, a moment)."""
    layout = state.tp
    out = {}
    leaves = state.param_dict() if flat is None else state._leaves(flat)
    for name, p in leaves.items():
        if name in layout.dims:
            p = _gather(p.detach(), layout.dims[name], ModelAxis(
                layout.group, layout.rank, layout.size))
        out[name] = p.detach().clone()
    return out


__all__ = [
    "TPLayout",
    "copy_to_model",
    "flax_path",
    "gather_from_model",
    "gather_params_tp",
    "gathered_weights",
    "make_2d_mesh",
    "model_axis",
    "model_parts",
    "reduce_from_model",
    "shard_state_tp",
    "tp_dim",
    "tp_global_norm",
    "tp_param_shardings",
]
