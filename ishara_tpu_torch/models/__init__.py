from .blocks import (
    Conv1DBlock,
    ConformerBlock,
    SqueezeformerBlock,
    TransformerBlock,
)
from .encoder import IsharaEncoder, build_model
from .fused import FusedEncoder, fused_encoder_forward
from .layers import (
    ECA,
    BatchNorm,
    CausalDWConv1D,
    ConformerConvModule,
    FastDropout,
    FastDropoutAdd,
    FusedFFN,
    MultiHeadSelfAttention,
    RowDropout,
    SqueezeExcite,
    SqueezeformerConvModule,
    positional_encoding,
)

__all__ = [
    "BatchNorm",
    "CausalDWConv1D",
    "Conv1DBlock",
    "ConformerBlock",
    "ConformerConvModule",
    "ECA",
    "FastDropout",
    "FastDropoutAdd",
    "FusedEncoder",
    "FusedFFN",
    "IsharaEncoder",
    "MultiHeadSelfAttention",
    "RowDropout",
    "SqueezeExcite",
    "SqueezeformerBlock",
    "SqueezeformerConvModule",
    "TransformerBlock",
    "build_model",
    "fused_encoder_forward",
    "positional_encoding",
]
