"""Encoder blocks as ``nn.Module``s (port of ``ishara_tpu/models/blocks.py``:
``Conv1DBlock``, ``SqueezeformerBlock``, ``ConformerBlock`` and
``TransformerBlock``), eval and training mode. ``forward`` takes
``training`` and ``seed``, the table of the step's dropout-site seeds (see
:mod:`ishara_tpu_torch.models.layers`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    BN_EPS,
    BN_MOMENTUM,
    ECA,
    LN_EPS,
    BatchNorm,
    CausalDWConv1D,
    ConformerConvModule,
    Dense,
    FastDropoutAdd,
    FusedFFN,
    LayerNorm,
    MultiHeadSelfAttention,
    RowDropout,
    SqueezeformerConvModule,
    number_dropout_sites,
)


class Conv1DBlock(nn.Module):
    """MBConv-style conv block: Linear expand (swish) -> causal depthwise
    conv -> BN -> ECA -> Linear project -> row dropout, plus the input when
    the channel counts match."""

    def __init__(self, channels_in: int, channels: int, kernel_size: int,
                 dilation_rate: int = 1, expand_ratio: int = 2,
                 drop_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels_in * expand_ratio
        self.skip = channels_in == channels
        self.expand = Dense(channels_in, c, dtype=dtype)
        self.dw = CausalDWConv1D(c, kernel_size, dilation_rate, dtype=dtype)
        self.bn = BatchNorm(c, eps=BN_EPS, momentum=BN_MOMENTUM, dtype=dtype)
        self.eca = ECA(dtype=dtype)
        self.project = Dense(c, channels, dtype=dtype)
        self.drop = RowDropout(drop_rate)
        number_dropout_sites(self)

    def forward(self, x, mask=None, training: bool = False, seed=None):
        h = self.dw(F.silu(self.expand(x)))
        h = self.project(self.eca(self.bn(h, training), mask))
        h = self.drop(h, training, seed)
        return h + x if self.skip else h


class SqueezeformerBlock(nn.Module):
    """Pre-LN FFN -> pre-LN MHSA -> conv module (with SE) -> pre-LN FFN,
    plain residuals with shared dropout: each FFN drops its hidden and its
    branch, the attention its weights and its branch. ``causal=True``
    makes the attention causal (within ``attn_context`` keys when that is
    above 0) and the SE gate a running mean."""

    def __init__(self, dim: int, num_heads: int = 8, expansion_factor: int = 4,
                 kernel_size: int = 31, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 causal: bool = False, attn_context: int = 0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.ffn1 = FusedFFN(dim, expansion_factor, dropout, res_rate=dropout,
                             dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.mha = MultiHeadSelfAttention(dim, num_heads, dropout, dtype=dtype,
                                          use_flash=use_flash, causal=causal,
                                          attn_context=attn_context)
        self.mha_drop = FastDropoutAdd(dropout)
        self.conv = SqueezeformerConvModule(dim, kernel_size, expansion_factor,
                                            dtype=dtype, causal_se=causal)
        self.norm3 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.ffn2 = FusedFFN(dim, expansion_factor, dropout, res_rate=dropout,
                             dtype=dtype)
        number_dropout_sites(self)

    def forward(self, x, mask=None, training: bool = False, seed=None):
        x = self.ffn1(x, self.norm1(x), training, seed)
        h = self.mha(self.norm2(x), mask, training, seed)
        x = self.mha_drop(x, h, training, seed)
        x = self.conv(x, mask, training)
        return self.ffn2(x, self.norm3(x), training, seed)


class ConformerBlock(nn.Module):
    """FFN -> MHSA -> conv module -> FFN with plain residuals; ``ln1`` is
    shared by the FFN1 and MHSA pre-norms (reference quirk). The FFNs drop
    their hidden only, the attention its weights only. ``causal=True``
    makes the attention causal (within ``attn_context`` keys when that is
    above 0) and the depthwise conv left-padded."""

    def __init__(self, dim: int, num_heads: int = 8, expand: int = 4,
                 kernel_size: int = 31, attn_dropout: float = 0.0,
                 drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, causal: bool = False,
                 attn_context: int = 0):
        super().__init__()
        self.ln1 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.ffn1 = FusedFFN(dim, expand, drop_rate, res_rate=0.0, dtype=dtype)
        self.mha = MultiHeadSelfAttention(dim, num_heads, attn_dropout,
                                          dtype=dtype, use_flash=use_flash,
                                          causal=causal,
                                          attn_context=attn_context)
        self.conv = ConformerConvModule(dim, kernel_size, dtype=dtype,
                                        causal=causal)
        self.ln2 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.ffn2 = FusedFFN(dim, expand, drop_rate, res_rate=0.0, dtype=dtype)
        number_dropout_sites(self)

    def forward(self, x, mask=None, training: bool = False, seed=None):
        x = self.ffn1(x, self.ln1(x), training, seed)
        x = x + self.mha(self.ln1(x), mask, training, seed)
        x = self.conv(x, training)
        return self.ffn2(x, self.ln2(x), training, seed)


class TransformerBlock(nn.Module):
    """Pre-LN MHSA, then pre-LN swish FFN whose two Linears have no bias,
    each branch behind a row dropout and a plain residual."""

    def __init__(self, dim: int = 256, num_heads: int = 6, expand: int = 4,
                 attn_dropout: float = 0.0, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
        self.ln1 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.mha = MultiHeadSelfAttention(dim, num_heads, attn_dropout,
                                          dtype=dtype, use_flash=use_flash)
        self.drop1 = RowDropout(drop_rate)
        self.ln2 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.fc1 = Dense(dim, dim * expand, bias=False, dtype=dtype)
        self.fc2 = Dense(dim * expand, dim, bias=False, dtype=dtype)
        self.drop2 = RowDropout(drop_rate)
        number_dropout_sites(self)

    def forward(self, x, mask=None, training: bool = False, seed=None):
        h = self.mha(self.ln1(x), mask, training, seed)
        x = x + self.drop1(h, training, seed)
        h = self.fc2(F.silu(self.fc1(self.ln2(x))))
        return x + self.drop2(h, training, seed)
