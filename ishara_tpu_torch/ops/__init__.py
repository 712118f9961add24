from .fused_block import (
    FusedEncoder,
    fused_conformer_block,
    fused_conformer_stack,
    fused_encoder_forward,
    fused_squeezeformer_block,
    fused_squeezeformer_stack,
)

__all__ = [
    "FusedEncoder",
    "fused_conformer_block",
    "fused_conformer_stack",
    "fused_encoder_forward",
    "fused_squeezeformer_block",
    "fused_squeezeformer_stack",
]
