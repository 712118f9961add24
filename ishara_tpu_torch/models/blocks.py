"""Encoder blocks as ``nn.Module``s (port of ``ishara_tpu/models/blocks.py``:
``Conv1DBlock``, ``SqueezeformerBlock``, ``ConformerBlock`` and
``TransformerBlock``), eval mode. Dropouts are eval no-ops and are not
built."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import (
    BN_EPS,
    BN_MOMENTUM,
    ECA,
    LN_EPS,
    CausalDWConv1D,
    ConformerConvModule,
    FeedForwardModule,
    MultiHeadSelfAttention,
    SqueezeformerConvModule,
)


class Conv1DBlock(nn.Module):
    """MBConv-style conv block: Linear expand (swish) -> causal depthwise
    conv -> BN -> ECA -> Linear project, plus the input when the channel
    counts match."""

    def __init__(self, channels_in: int, channels: int, kernel_size: int,
                 dilation_rate: int = 1, expand_ratio: int = 2):
        super().__init__()
        c = channels_in * expand_ratio
        self.skip = channels_in == channels
        self.expand = nn.Linear(channels_in, c)
        self.dw = CausalDWConv1D(c, kernel_size, dilation_rate)
        self.bn = nn.BatchNorm1d(c, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.eca = ECA()
        self.project = nn.Linear(c, channels)

    def forward(self, x, mask=None):
        h = self.dw(F.silu(self.expand(x)))
        h = self.bn(h.transpose(1, 2)).transpose(1, 2)
        h = self.project(self.eca(h, mask))
        return h + x if self.skip else h


class SqueezeformerBlock(nn.Module):
    """Pre-LN FFN -> pre-LN MHSA -> conv module (with SE) -> pre-LN FFN,
    each with a plain residual."""

    def __init__(self, dim: int, num_heads: int = 8, expansion_factor: int = 4,
                 kernel_size: int = 31):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn1 = FeedForwardModule(dim, expansion_factor)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mha = MultiHeadSelfAttention(dim, num_heads)
        self.conv = SqueezeformerConvModule(dim, kernel_size, expansion_factor)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn2 = FeedForwardModule(dim, expansion_factor)

    def forward(self, x, mask=None):
        x = x + self.ffn1(self.norm1(x))
        x = x + self.mha(self.norm2(x), mask)
        x = self.conv(x, mask)
        return x + self.ffn2(self.norm3(x))


class ConformerBlock(nn.Module):
    """FFN -> MHSA -> conv module -> FFN with plain residuals; ``ln1`` is
    shared by the FFN1 and MHSA pre-norms (reference quirk)."""

    def __init__(self, dim: int, num_heads: int = 8, expand: int = 4,
                 kernel_size: int = 31):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn1 = FeedForwardModule(dim, expand)
        self.mha = MultiHeadSelfAttention(dim, num_heads)
        self.conv = ConformerConvModule(dim, kernel_size)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn2 = FeedForwardModule(dim, expand)

    def forward(self, x, mask=None):
        x = x + self.ffn1(self.ln1(x))
        x = x + self.mha(self.ln1(x), mask)
        x = self.conv(x)
        return x + self.ffn2(self.ln2(x))


class TransformerBlock(nn.Module):
    """Pre-LN MHSA, then pre-LN swish FFN whose two Linears have no bias,
    each with a plain residual."""

    def __init__(self, dim: int = 256, num_heads: int = 6, expand: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mha = MultiHeadSelfAttention(dim, num_heads)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, dim * expand, bias=False)
        self.fc2 = nn.Linear(dim * expand, dim, bias=False)

    def forward(self, x, mask=None):
        x = x + self.mha(self.ln1(x), mask)
        return x + self.fc2(F.silu(self.fc1(self.ln2(x))))
