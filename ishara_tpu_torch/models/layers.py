"""Core encoder layers as ``nn.Module``s (port of ``ishara_tpu/models/
layers.py``), eval mode and non-causal only.

Tensors are ``[B, T, C]`` as in the reference. The reference's quirks that
affect weight parity are kept: attention scores scaled by ``dim**-0.5`` over
the full width; the Conformer conv module's 'same' depthwise conv, BN with no
activation, post-LN residual and Keras-default eps (1e-3); masked GAP in SE.

Parameter layout follows PyTorch: ``nn.Linear.weight`` is ``[out, in]`` and
``nn.Conv1d.weight`` ``[out, in/groups, K]``; :mod:`ishara_tpu_torch.bridge`
converts the flax trees.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

# Keras parity epsilons.
LN_EPS = 1e-6
BN_EPS = 1e-3
# The reference Conformer conv module builds its norms with Keras defaults.
LN_EPS_DEFAULT = 1e-3
# flax BatchNorm momentum is the decay of the running stats (0.95 / 0.99);
# torch's is the weight of the new batch. Only training reads them.
BN_MOMENTUM = 1.0 - 0.95
BN_MOMENTUM_DEFAULT = 1.0 - 0.99


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


def _conv_tc(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to a [B, T, C] tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class SqueezeExcite(nn.Module):
    """SE gate: masked GAP -> Linear(C/r, swish) -> Linear(C, sigmoid)."""

    def __init__(self, channels: int, reduction_ratio: int = 8):
        super().__init__()
        r = max(1, channels // reduction_ratio)
        self.fc1 = nn.Linear(channels, r)
        self.fc2 = nn.Linear(r, channels)

    def forward(self, x, mask=None):
        g = masked_global_average_pool(x, mask)
        g = torch.sigmoid(self.fc2(F.silu(self.fc1(g))))
        return x * g[:, None, :]


class ECA(nn.Module):
    """Efficient channel attention: masked GAP -> Conv1d(1, 1, k) over the
    channel axis ('same' zero padding ((k-1)//2, k//2), no bias) -> sigmoid
    gate."""

    def __init__(self, kernel_size: int = 5):
        super().__init__()
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv = nn.Conv1d(1, 1, kernel_size, bias=False)

    def forward(self, x, mask=None):
        g = masked_global_average_pool(x, mask)[:, None, :]    # [B, 1, C]
        g = torch.sigmoid(self.conv(F.pad(g, self.pad)))[:, 0, :]
        return x * g[:, None, :]


class CausalDWConv1D(nn.Module):
    """Left-padded depthwise conv: pad (k-1)*dilation, then VALID."""

    def __init__(self, channels: int, kernel_size: int = 17,
                 dilation_rate: int = 1, use_bias: bool = False):
        super().__init__()
        self.pad = dilation_rate * (kernel_size - 1)
        self.dwconv = nn.Conv1d(channels, channels, kernel_size,
                                dilation=dilation_rate, groups=channels,
                                bias=use_bias)

    def forward(self, x):
        return _conv_tc(self.dwconv, F.pad(x, (0, 0, self.pad, 0)))


class MultiHeadSelfAttention(nn.Module):
    """Fused-QKV attention with padding mask (the reference's einsum path).

    The QKV weight's output axis is laid out per head as ``[q|k|v]`` blocks
    of ``Dh`` -- not ``[Q|K|V]`` over the whole width. Scores are scaled by
    ``dim**-0.5`` and masked keys filled with ``finfo.min``."""

    def __init__(self, dim: int = 256, num_heads: int = 4):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim, bias=False)

    def forward(self, x, mask=None):
        B, T, _ = x.shape
        H = self.num_heads
        Dh = self.dim // H
        qkv = self.qkv(x).reshape(B, T, H, 3 * Dh).transpose(1, 2)
        q, k, v = qkv.split(Dh, dim=-1)
        attn = torch.einsum("bhqd,bhkd->bhqk", q, k) * self.dim ** -0.5
        if mask is not None:
            attn = attn.masked_fill(~mask[:, None, None, :],
                                    torch.finfo(attn.dtype).min)
        attn = attn.softmax(dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.proj(out.transpose(1, 2).reshape(B, T, self.dim))


class FeedForwardModule(nn.Module):
    """Linear(dim*exp, swish) -> Linear(dim) (``FeedForwardModule`` and the
    eval-mode math of ``FusedFFN``; the residual is added by the block)."""

    def __init__(self, dim: int, expansion_factor: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * expansion_factor)
        self.fc2 = nn.Linear(dim * expansion_factor, dim)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class SqueezeformerConvModule(nn.Module):
    """LN -> pw(dim*exp) swish -> causal DW conv swish -> pw(dim) -> SE
    -> +residual."""

    def __init__(self, dim: int, kernel_size: int, expansion_factor: int = 2):
        super().__init__()
        e = dim * expansion_factor
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pw1 = nn.Conv1d(dim, e, 1)
        self.dw = CausalDWConv1D(e, kernel_size)
        self.pw2 = nn.Conv1d(e, dim, 1)
        self.se = SqueezeExcite(dim)

    def forward(self, x, mask=None):
        h = F.silu(_conv_tc(self.pw1, self.norm(x)))
        h = F.silu(self.dw(h))
        h = _conv_tc(self.pw2, h)
        return self.se(h, mask) + x


class ConformerConvModule(nn.Module):
    """pw(2*dim) -> GLU -> 'same' DW conv (+bias) -> BN -> pw(dim)
    -> LN(x + residual), with Keras-default eps 1e-3 for BN and LN."""

    def __init__(self, dim: int, kernel_size: int = 31):
        super().__init__()
        self.dim = dim
        # 'same' for stride 1: (k-1)//2 on the left, k//2 on the right
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.pw1 = nn.Conv1d(dim, 2 * dim, 1)
        self.dw = nn.Conv1d(dim, dim, kernel_size, groups=dim)
        self.bn = nn.BatchNorm1d(dim, eps=BN_EPS, momentum=BN_MOMENTUM_DEFAULT)
        self.pw2 = nn.Conv1d(dim, dim, 1)
        self.ln = nn.LayerNorm(dim, eps=LN_EPS_DEFAULT)

    def forward(self, x):
        h = _conv_tc(self.pw1, x)
        a, b = h.split(self.dim, dim=-1)
        h = a * torch.sigmoid(b)
        h = F.pad(h, (0, 0) + self.pad).transpose(1, 2)
        h = self.bn(self.dw(h))
        h = self.pw2(h).transpose(1, 2)
        return self.ln(h + x)
