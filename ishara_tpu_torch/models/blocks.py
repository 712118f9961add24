"""Encoder blocks as ``nn.Module``s (port of ``ishara_tpu/models/blocks.py``
``SqueezeformerBlock`` and ``ConformerBlock``), eval mode. Dropouts are eval
no-ops and are not built."""

from __future__ import annotations

from torch import nn

from .layers import (
    LN_EPS,
    ConformerConvModule,
    FeedForwardModule,
    MultiHeadSelfAttention,
    SqueezeformerConvModule,
)


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
