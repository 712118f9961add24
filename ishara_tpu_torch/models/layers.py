"""Core encoder layers as ``nn.Module``s (port of ``ishara_tpu/models/
layers.py``), eval and training mode, bidirectional or causal.

Tensors are ``[B, T, C]`` as in the reference. The reference's quirks that
affect weight parity are kept: attention scores scaled by ``dim**-0.5`` over
the full width; the Conformer conv module's 'same' depthwise conv, BN with no
activation, post-LN residual and Keras-default eps (1e-3); masked GAP in SE.

Parameter layout follows PyTorch: ``nn.Linear.weight`` is ``[out, in]`` and
``nn.Conv1d.weight`` ``[out, in/groups, K]``; :mod:`ishara_tpu_torch.bridge`
converts the flax trees.

**Compute dtype** (``cfg.dtype``, "float32" or "bfloat16") follows flax's
rule, not ``torch.autocast``'s: parameters stay float32; :class:`Dense` and
:class:`Conv` cast their input and their parameters to the compute dtype;
:class:`LayerNorm` and :class:`BatchNorm` take their statistics and normalise
in float32 and round once, to the compute dtype, on the way out.

**Training mode** is an argument (``training=True``), not the module's flag.
A step's dropout masks are a pure function of the step's dropout seed and
of each site's number, given at construction by
:func:`number_dropout_sites`: the encoder makes the table of every site's
seeds from the step's seed once a step
(:func:`ishara_tpu_torch.ops.dropout.site_seed_table`), and that table is the
``seed`` argument of every layer and block below it; nothing draws
from a stateful generator, so the same (seed, step) gives the same masks
whatever path was taken before.

**Data parallelism.** Inside :func:`ishara_tpu_torch.parallel.shard.
batch_shard` a process holds rows ``[row0, row0 + local)`` of a global
batch: :class:`BatchNorm` takes its statistics over the global batch,
every dropout site offsets its mask to its rows' flat positions in the
global tensor, and the kernel selection is keyed on the global batch -- so
the step computes what the unsharded step computes on all rows.

**Tensor parallelism.** After :func:`ishara_tpu_torch.parallel.tp.
shard_state_tp` a :class:`MultiHeadSelfAttention` or :class:`FusedFFN` may
hold its slice of ``tp_parts`` (its heads, its hidden columns): it runs its
two products on the slice between the ``model`` axis's copy and reduction,
and draws its dropout masks at the slice's positions in the global tensor.

**Recomputation.** A ``remat`` block's forward runs again in the backward
pass; within :func:`frozen_running_stats` (the recomputation's context)
:class:`BatchNorm` leaves its running statistics where the first forward
put them, as flax's ``nn.remat`` applies the update once.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..config import BN_EPS, LN_EPS, LN_EPS_DEFAULT
from ..ops import attention, attention_blocked, conv_kernel, selection
from ..ops.dropout import fast_dropout, fast_dropout_add, keep_mask, site_seeds
from ..ops.ffn_kernel import ffn_residual
from ..parallel.shard import (
    current_shard,
    element_offset,
    global_batch,
    split_offset,
    sum_over_shards,
)
from ..parallel.tp import copy_to_model, model_axis, reduce_from_model

# flax BatchNorm momentum: the decay of the running statistics.
BN_MOMENTUM = 0.95
BN_MOMENTUM_DEFAULT = 0.99

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def on_card(x: torch.Tensor) -> bool:
    """Whether the training kernels' paths apply to ``x``: it lies on a CUDA
    device. Every layer below asks here, so a test can take the kernel
    paths on the CPU, where each wrapper runs its plain version."""
    return x.is_cuda


_frozen_stats = False


@contextlib.contextmanager
def frozen_running_stats():
    """Within the block, training-mode :class:`BatchNorm` layers normalise
    with the batch's statistics but do not move their running ones (a
    module global: the recomputation may run on an autograd thread)."""
    global _frozen_stats
    saved, _frozen_stats = _frozen_stats, True
    try:
        yield
    finally:
        _frozen_stats = saved


def compute_dtype(name) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if isinstance(name, torch.dtype) and name in _DTYPES.values():
        return name
    if name not in _DTYPES:
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', got "
                         f"{name!r}")
    return _DTYPES[name]


def positional_encoding(maxlen: int, dim: int) -> np.ndarray:
    """Fixed sin/cos encoding, concat layout [sin | cos] (not interleaved)."""
    depth = dim / 2
    positions = np.arange(maxlen, dtype=np.float32)[:, None]
    depths = np.arange(depth, dtype=np.float32)[None, :] / depth
    angle_rates = 1.0 / np.power(10000.0, depths).astype(np.float32)
    angle_rads = positions * angle_rates
    return np.concatenate([np.sin(angle_rads), np.cos(angle_rads)], axis=-1)


def masked_global_average_pool(x: torch.Tensor,
                               mask: torch.Tensor | None) -> torch.Tensor:
    """[B, T, C] -> [B, C] mean over valid frames, denominator max(sum m, 1)."""
    if mask is None:
        return x.mean(dim=1)
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def causal_masked_mean(x: torch.Tensor,
                       mask: torch.Tensor | None) -> torch.Tensor:
    """[B, T, C] -> [B, T, C] running mean over the valid frames <= t (the
    causal form of the masked average pool; denominator max(count, 1))."""
    m = torch.ones_like(x[..., :1]) if mask is None \
        else mask[..., None].to(x.dtype)
    return torch.cumsum(x * m, dim=1) / torch.clamp(torch.cumsum(m, dim=1),
                                                    min=1.0)


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Conv(nn.Conv1d):
    """``nn.Conv1d`` with float32 parameters that computes in ``dtype`` on a
    channel-last ``[B, T, C]`` tensor. A pointwise conv (one tap, stride 1,
    no padding, one group) is the product it is, ``F.linear``: cuBLAS's is
    deterministic, where cuDNN may take a float32 weight gradient with
    atomic sums, so the same step would not give the same bits twice."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32, **kw):
        super().__init__(in_channels, out_channels, kernel_size, **kw)
        self.compute_dtype = dtype
        self.pointwise = (self.kernel_size, self.stride, self.padding,
                          self.dilation, self.groups) \
            == ((1,), (1,), (0,), (1,), 1)

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.pointwise:
            return F.linear(x.to(dt), self.weight[:, :, 0].to(dt), b)
        y = F.conv1d(x.to(dt).transpose(1, 2), self.weight.to(dt), b,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.transpose(1, 2)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis: float32 statistics and arithmetic, one
    rounding to ``dtype``."""

    def __init__(self, dim: int, eps: float = LN_EPS,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class BatchNorm(nn.Module):
    """BatchNorm over a channel-last tensor with flax's semantics.

    Training: statistics over every axis but the last -- batch and time, the
    padding mask ignored -- in float32, the variance as ``mean(x^2) -
    mean(x)^2`` clipped at 0; the running statistics move as ``running =
    momentum * running + (1 - momentum) * batch`` with the **biased** batch
    variance (``torch.nn.BatchNorm1d`` uses the unbiased one and the other
    momentum convention), in place. Eval: the running statistics. Either
    way the arithmetic is float32 and the result is rounded once to
    ``dtype``. The ``state_dict`` keys are ``nn.BatchNorm1d``'s.

    Inside a batch shard (:mod:`ishara_tpu_torch.parallel.shard`) the
    statistics are the global batch's: the f32 sums of ``x`` and ``x^2``
    over this process's rows, summed over every process by a differentiable
    all-reduce, over the global count (not ``nn.SyncBatchNorm``, whose
    running variance is the unbiased one)."""

    def __init__(self, channels: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.momentum, self.compute_dtype = eps, momentum, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x, training: bool = False):
        xf = x.to(torch.float32)
        if training:
            axes = tuple(range(x.dim() - 1))
            sh = current_shard()
            if sh.groups:
                c = x.shape[-1]
                sums = sum_over_shards(torch.cat(
                    [xf.sum(dim=axes), (xf * xf).sum(dim=axes)]))
                # the count over the global batch: rows / local times ours
                n = (xf.numel() // c) * sh.rows // sh.local
                mean = sums[:c] / n
                var = torch.clamp(sums[c:] / n - mean * mean, min=0.0)
            else:
                mean = xf.mean(dim=axes)
                var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean,
                                  min=0.0)
            if not _frozen_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(self.compute_dtype)


# ---------------------------------------------------------------------------
# Dropout sites
# ---------------------------------------------------------------------------

def number_dropout_sites(module: nn.Module) -> int:
    """Give every dropout site under ``module`` its number (``site`` = its
    position in ``module.modules()``'s order) and return how many there are.
    The encoder calls this once; a block built alone numbers its own."""
    n = 0
    for m in module.modules():
        if hasattr(m, "site"):
            m.site = n
            n += 1
    return n


def _need_seed(seed):
    if seed is None:
        raise ValueError("training with dropout needs the step's dropout "
                         "seed (the table of its sites' seeds)")
    return seed


class FastDropout(nn.Module):
    """Inverted dropout with the (seed, position) mask of
    :func:`ishara_tpu_torch.ops.dropout.fast_dropout`."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate, self.site = float(rate), 0

    def forward(self, x, training: bool = False, seed=None):
        if not training or self.rate <= 0.0:
            return x
        return fast_dropout(x, site_seeds(_need_seed(seed), 1, self.site),
                            self.rate, element_offset(x))


class FastDropoutAdd(nn.Module):
    """``res + dropout(h)`` in one pass (``fast_dropout_add``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate, self.site = float(rate), 0

    def forward(self, res, h, training: bool = False, seed=None):
        if not training or self.rate <= 0.0:
            return res + h
        return fast_dropout_add(
            res, h, site_seeds(_need_seed(seed), 1, self.site), self.rate,
            element_offset(h))


class RowDropout(nn.Module):
    """Keras ``Dropout(noise_shape=(None, 1, 1))``: drops whole samples. The
    ``[B]`` keep mask is the same Philox function of (site seed, row)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate, self.site = float(rate), 0

    def forward(self, x, training: bool = False, seed=None):
        if not training or self.rate <= 0.0:
            return x
        keep = keep_mask(site_seeds(_need_seed(seed), 1, self.site),
                         (x.shape[0],), self.rate,
                         element_offset(x) // x[0].numel())
        scale = keep.to(x.dtype) / (1.0 - self.rate)
        return x * scale.reshape((-1,) + (1,) * (x.dim() - 1))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class SqueezeExcite(nn.Module):
    """SE gate: masked GAP -> Linear(C/r, swish) -> Linear(C, sigmoid).

    ``causal=True`` pools with the running mean (:func:`causal_masked_mean`)
    instead, so the gate is ``[B, T, C]`` and frame t's sees only frames
    <= t; the parameters are the same either way."""

    def __init__(self, channels: int, reduction_ratio: int = 8,
                 dtype: torch.dtype = torch.float32, causal: bool = False):
        super().__init__()
        r = max(1, channels // reduction_ratio)
        self.causal = causal
        self.fc1 = Dense(channels, r, dtype=dtype)
        self.fc2 = Dense(r, channels, dtype=dtype)

    def forward(self, x, mask=None):
        if self.causal:
            g = causal_masked_mean(x, mask)
        else:
            g = masked_global_average_pool(x, mask)[:, None, :]
        return x * torch.sigmoid(self.fc2(F.silu(self.fc1(g))))


class ECA(nn.Module):
    """Efficient channel attention: masked GAP -> Conv1d(1, 1, k) over the
    channel axis ('same' zero padding ((k-1)//2, k//2), no bias) -> sigmoid
    gate."""

    def __init__(self, kernel_size: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv = nn.Conv1d(1, 1, kernel_size, bias=False)
        self.compute_dtype = dtype

    def forward(self, x, mask=None):
        dt = self.compute_dtype
        g = masked_global_average_pool(x, mask)[:, None, :]    # [B, 1, C]
        g = F.conv1d(F.pad(g.to(dt), self.pad), self.conv.weight.to(dt))
        return x * torch.sigmoid(g[:, 0, :])[:, None, :]


class CausalDWConv1D(nn.Module):
    """Left-padded depthwise conv: pad (k-1)*dilation, then VALID."""

    def __init__(self, channels: int, kernel_size: int = 17,
                 dilation_rate: int = 1, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad = dilation_rate * (kernel_size - 1)
        self.dwconv = Conv(channels, channels, kernel_size, dtype=dtype,
                           dilation=dilation_rate, groups=channels,
                           bias=use_bias)

    def forward(self, x):
        return self.dwconv(F.pad(x, (0, 0, self.pad, 0)))


class MultiHeadSelfAttention(nn.Module):
    """Fused-QKV attention with padding mask.

    The QKV weight's output axis is laid out per head as ``[q|k|v]`` blocks
    of ``Dh`` -- not ``[Q|K|V]`` over the whole width. Scores are scaled by
    ``dim**-0.5``.

    Three paths, as in the reference. The einsum path fills masked keys
    with ``finfo.min`` and, in training, puts ``fast_dropout`` on the
    probabilities. The kernel path is
    :func:`ishara_tpu_torch.ops.attention.flash_mhsa` with the dropout inside
    it. Both key the mask by the same site seed and index it by the flat
    position in ``[B, H, T, T]``, so the path taken does not change which
    weights are dropped. The kernel path is taken in training on a CUDA
    device when ``T <= 384`` and ``selection.train_attention`` says "flash"
    for the geometry, and whenever ``use_flash`` forces it. The tiled path
    is :func:`ishara_tpu_torch.ops.attention_blocked.flash_mhsa_blocked`
    (any ``T``, no dropout inside, the mask as an additive ``-1e30`` key
    bias): taken in training on a CUDA device when the attention dropout is
    exactly 0 and the table says "flash_blocked". The choice is the table's
    alone: a geometry a kernel cannot take raises there. Eval always takes
    the einsum path (every row's ``serve_attn``).

    ``causal=True`` (the streaming families) lets query ``qi`` attend to the
    keys ``ki <= qi``, and with ``attn_context > 0`` only to those with
    ``qi - ki < attn_context``. It always takes the einsum path, before any
    selection, as the reference does: neither kernel applies that mask.

    With ``tp_parts`` > 1 the module holds ``num_heads / tp_parts`` heads:
    the rows of ``qkv`` and the columns of ``proj`` of one ``model``
    process's heads (the per-head ``[q|k|v]`` layout makes a contiguous
    slice whole heads), and the projection's partial sums are reduced over
    ``model``. Either path draws the unsharded step's mask at its heads'
    positions (``runs``), so the table's choice stands."""

    tp_parts = 1

    def __init__(self, dim: int = 256, num_heads: int = 4,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, causal: bool = False,
                 attn_context: int = 0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.dropout, self.use_flash = float(dropout), use_flash
        self.causal, self.attn_context = causal, int(attn_context)
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.site = 0                       # the dropout site, either path

    def forward(self, x, mask=None, training: bool = False, seed=None):
        B, T, _ = x.shape
        parts = self.tp_parts
        axis = model_axis(parts)
        H = self.num_heads // parts
        Dh = self.dim // self.num_heads
        qkv = self.qkv(x if axis is None else copy_to_model(x, axis))
        q, k, v = qkv.reshape(B, T, H, 3 * Dh).transpose(1, 2).split(Dh, -1)
        scale = self.dim ** -0.5
        rate = self.dropout if training else 0.0
        s = site_seeds(_need_seed(seed), 1, self.site) if rate > 0.0 else None
        if self.causal:
            path, flash = "einsum", False
        else:
            path = selection.train_attention(self.dim, T, rate > 0.0,
                                             global_batch(x)) \
                if training and on_card(x) else "einsum"
            flash = self.use_flash or (path == "flash"
                                       and T <= attention.MAX_T)
        # the mask's positions in the global [B, heads, T, T]
        off, runs = split_offset((B, H, T, T), parts,
                                 0 if axis is None else axis.rank, trailing=3)
        if path == "flash_blocked" and rate == 0.0:
            out = attention_blocked.flash_mhsa_blocked(
                q, k, v, self._bias(mask, B, T, x.device), scale)
        elif flash:
            out = attention.flash_mhsa(q, k, v,
                                       self._bias(mask, B, T, x.device), s,
                                       scale=scale, dropout_rate=rate,
                                       offset=off, runs=runs)
        else:
            attn = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
            keep = self._allowed(mask, T, x.device)
            if keep is not None:
                attn = attn.masked_fill(~keep, torch.finfo(attn.dtype).min)
            attn = attn.softmax(dim=-1)
            attn = fast_dropout(attn, s, rate, off, runs)
            out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = self.proj(out.transpose(1, 2).reshape(B, T, H * Dh))
        return out if axis is None else reduce_from_model(out, axis)

    def _allowed(self, mask, T, device):
        """The keys each query may attend to, broadcastable to ``[B, H, T,
        T]``, or None when all may."""
        keep = None if mask is None else mask[:, None, None, :]
        if self.causal:
            qi = torch.arange(T, device=device)[:, None]
            ki = torch.arange(T, device=device)[None, :]
            band = ki <= qi
            if self.attn_context > 0:
                band = band & (qi - ki < self.attn_context)
            keep = band if keep is None else keep & band
        return keep

    @staticmethod
    def _bias(mask, B, T, device):
        if mask is None:
            return torch.zeros((B, T), dtype=torch.float32, device=device)
        return attention.mask_to_bias(mask)


class FusedFFN(nn.Module):
    """``res + drop_res(Linear(drop(swish(Linear(x)))))``: the block FFN with
    its residual (reference ``FusedFFN``; ``fc1``/``fc2`` keep the keys of
    the plain feed-forward module).

    In training, with a dropout site active, on a CUDA device, at a geometry
    where ``selection.ffn_fused_when_dropout`` says so, the whole branch is
    one kernel, :func:`ishara_tpu_torch.ops.ffn_kernel.ffn_residual`, which
    reads ``fc1``/``fc2`` directly. Otherwise it is the composition, with
    ``fast_dropout`` on the hidden and ``fast_dropout_add`` on the way out.
    Both key the hidden's mask by the site's first seed and the output's by
    its second, so the path taken does not change what is dropped.
    ``res_rate`` is the residual branch's dropout (the Squeezeformer sites;
    0 for the Conformer's).

    With ``tp_parts`` > 1 the module holds one ``model`` process's slice of
    the hidden columns (``fc1``'s rows and bias, ``fc2``'s columns): the
    kernel or the composition gives the slice's partial sum of ``fc2``,
    with the unsharded step's hidden mask at its columns; the sums are
    reduced over ``model``, then come ``fc2``'s bias, the output's dropout
    and the residual."""

    tp_parts = 1

    def __init__(self, dim: int, expansion_factor: int = 4,
                 dropout: float = 0.1, res_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.dropout, self.res_rate = float(dropout), float(res_rate)
        self.fc1 = Dense(dim, dim * expansion_factor, dtype=dtype)
        self.fc2 = Dense(dim * expansion_factor, dim, dtype=dtype)
        self.site = 0                  # one site, two seeds, either path

    def forward(self, res, x, training: bool = False, seed=None):
        dropping = training and (self.dropout > 0.0 or self.res_rate > 0.0)
        axis = model_axis(self.tp_parts)
        if not dropping and axis is None:
            return res + self.fc2(F.silu(self.fc1(x)))
        seeds = site_seeds(_need_seed(seed), 2, self.site) if dropping \
            else None
        # this process's hidden columns [col0, col0 + m) of m * parts
        m = self.fc1.weight.shape[0]
        col0 = 0 if axis is None else axis.rank * m
        if axis is not None:
            x = copy_to_model(x, axis)
        if dropping and on_card(x) and selection.ffn_fused_when_dropout(
                self.dim, x.shape[1], global_batch(x)):
            # the kernel's row offset: in rows of x's [N, dim] flattening
            rows = element_offset(x) // self.dim
            if axis is None:
                return ffn_residual(x, res, self.fc1.weight.t(),
                                    self.fc1.bias, self.fc2.weight.t(),
                                    self.fc2.bias, seeds, self.dropout,
                                    self.res_rate, rows)
            y = ffn_residual(x, None, self.fc1.weight.t(), self.fc1.bias,
                             self.fc2.weight.t(), None, seeds, self.dropout,
                             0.0, rows, hidden=(m * self.tp_parts, col0))
        else:
            h = F.silu(self.fc1(x))
            if dropping:
                h = fast_dropout(h, seeds[0:1], self.dropout, *split_offset(
                    h.shape, self.tp_parts, 0 if axis is None else axis.rank))
            if axis is None:
                y = self.fc2(h)
            else:
                dt = self.fc2.compute_dtype
                y = F.linear(h.to(dt), self.fc2.weight.to(dt))
        if axis is not None:
            y = reduce_from_model(y, axis) \
                + self.fc2.bias.to(self.fc2.compute_dtype)
        if not dropping:
            return res + y
        return fast_dropout_add(res, y, seeds[1:2], self.res_rate,
                                element_offset(y))


class SqueezeformerConvModule(nn.Module):
    """LN -> pw(dim*exp) swish -> causal DW conv swish -> pw(dim) -> SE
    -> +residual.

    In training on a CUDA device, where ``fused`` is on (``None`` reads
    ``selection.conv_module_fused`` for the geometry and dtype: f32 takes
    the composition), the whole branch with its residual is one kernel,
    :func:`ishara_tpu_torch.ops.conv_kernel.conv_module_residual`, whose
    backward recomputes the branch from ``x`` and the ``p`` its forward
    kept; it reads the module's own
    parameters in the reference's layouts (:meth:`kernel_args`). Otherwise,
    and always in eval, it is the composition. ``causal_se=True`` gates
    with the running mean (causal :class:`SqueezeExcite`) and always takes
    the composition: the kernel's gate is the whole sequence's."""

    def __init__(self, dim: int, kernel_size: int, expansion_factor: int = 2,
                 dtype: torch.dtype = torch.float32,
                 fused: bool | None = None, causal_se: bool = False):
        super().__init__()
        e = dim * expansion_factor
        self.dim, self.fused, self.causal_se = dim, fused, causal_se
        self.norm = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.pw1 = Conv(dim, e, 1, dtype=dtype)
        self.dw = CausalDWConv1D(e, kernel_size, dtype=dtype)
        self.pw2 = Conv(e, dim, 1, dtype=dtype)
        self.se = SqueezeExcite(dim, dtype=dtype, causal=causal_se)

    def kernel_args(self, x, mask=None) -> tuple:
        """The kernel's arguments after ``x``: the mask as float (all ones
        when absent), then LN scale and bias, ``w1 [D, E]``, ``b1``,
        ``wdw [K, E]``, ``w2 [E, D]``, ``b2``, ``wf1 [D, r]``, ``bf1``,
        ``wf2 [r, D]``, ``bf2`` -- views of the parameters, so gradients
        reach them. (The depthwise conv has no bias.)"""
        m = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device) \
            if mask is None else mask.to(torch.float32)
        return (m, self.norm.weight, self.norm.bias,
                self.pw1.weight[:, :, 0].t(), self.pw1.bias,
                self.dw.dwconv.weight[:, 0, :].t(),
                self.pw2.weight[:, :, 0].t(), self.pw2.bias,
                self.se.fc1.weight.t(), self.se.fc1.bias,
                self.se.fc2.weight.t(), self.se.fc2.bias)

    def forward(self, x, mask=None, training: bool = False):
        if training and on_card(x) and not self.causal_se and (
                selection.conv_module_fused(self.dim, x.shape[1],
                                            global_batch(x), x.dtype)
                if self.fused is None else self.fused):
            return conv_kernel.conv_module_residual(
                x, *self.kernel_args(x, mask))
        h = F.silu(self.pw1(self.norm(x)))
        h = F.silu(self.dw(h))
        h = self.pw2(h)
        return self.se(h, mask) + x


class ConformerConvModule(nn.Module):
    """pw(2*dim) -> GLU -> 'same' DW conv (+bias) -> BN -> pw(dim)
    -> LN(x + residual), with Keras-default eps 1e-3 for BN and LN and BN
    momentum 0.99. ``causal=True`` pads the depthwise conv by ``k-1`` on
    the left only."""

    def __init__(self, dim: int, kernel_size: int = 31,
                 dtype: torch.dtype = torch.float32, causal: bool = False):
        super().__init__()
        self.dim = dim
        # 'same' for stride 1: (k-1)//2 on the left, k//2 on the right
        self.pad = (kernel_size - 1, 0) if causal \
            else ((kernel_size - 1) // 2, kernel_size // 2)
        self.pw1 = Conv(dim, 2 * dim, 1, dtype=dtype)
        self.dw = Conv(dim, dim, kernel_size, dtype=dtype, groups=dim)
        self.bn = BatchNorm(dim, eps=BN_EPS, momentum=BN_MOMENTUM_DEFAULT,
                            dtype=dtype)
        self.pw2 = Conv(dim, dim, 1, dtype=dtype)
        self.ln = LayerNorm(dim, eps=LN_EPS_DEFAULT, dtype=dtype)

    def forward(self, x, training: bool = False):
        a, b = self.pw1(x).split(self.dim, dim=-1)
        h = a * torch.sigmoid(b)
        h = self.bn(self.dw(F.pad(h, (0, 0) + self.pad)), training)
        return self.ln(self.pw2(h) + x)
