from .blocks import (
    Conv1DBlock,
    ConformerBlock,
    SqueezeformerBlock,
    TransformerBlock,
)
from .encoder import IsharaEncoder, build_model
from .layers import (
    ECA,
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
    "Conv1DBlock",
    "ConformerBlock",
    "ConformerConvModule",
    "ECA",
    "FeedForwardModule",
    "IsharaEncoder",
    "MultiHeadSelfAttention",
    "SqueezeExcite",
    "SqueezeformerBlock",
    "SqueezeformerConvModule",
    "TransformerBlock",
    "build_model",
    "positional_encoding",
]
