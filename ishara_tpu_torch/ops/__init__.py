from .fused_block import (
    FusedEncoder,
    fused_conformer_block,
    fused_conformer_stack,
    fused_conv_group_stack,
    fused_encoder_forward,
    fused_squeezeformer_block,
    fused_squeezeformer_stack,
    quantize_serving_weights,
)

__all__ = [
    "FusedEncoder",
    "fused_conformer_block",
    "fused_conformer_stack",
    "fused_conv_group_stack",
    "fused_encoder_forward",
    "fused_squeezeformer_block",
    "fused_squeezeformer_stack",
    "quantize_serving_weights",
]
