from .blocks import ConformerBlock, SqueezeformerBlock
from .encoder import IsharaEncoder, build_model
from .layers import (
    CausalDWConv1D,
    ConformerConvModule,
    FeedForwardModule,
    MultiHeadSelfAttention,
    SqueezeExcite,
    SqueezeformerConvModule,
    positional_encoding,
)

__all__ = [
    "CausalDWConv1D",
    "ConformerBlock",
    "ConformerConvModule",
    "FeedForwardModule",
    "IsharaEncoder",
    "MultiHeadSelfAttention",
    "SqueezeExcite",
    "SqueezeformerBlock",
    "SqueezeformerConvModule",
    "build_model",
    "positional_encoding",
]
