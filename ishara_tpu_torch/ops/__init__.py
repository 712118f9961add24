"""The port's kernels, each beside its plain PyTorch version: the training
kernels (:mod:`.ctc_kernel`, :mod:`.dropout`, :mod:`.attention`,
:mod:`.ffn_kernel`) and the serving block stacks (:mod:`.fused_block`). The
model package builds on this one; nothing here imports it."""

from . import selection
from .attention import flash_mhsa, mask_to_bias, reference_mhsa
from .ctc import ctc_loss
from .ctc_kernel import ctc_loss_kernel
from .dropout import fast_dropout, fast_dropout_add, site_seed_table, site_seeds
from .ffn_kernel import debug_masks, ffn_residual
from .fused_block import (
    fused_conformer_block,
    fused_conformer_stack,
    fused_conv_group_stack,
    fused_squeezeformer_block,
    fused_squeezeformer_stack,
    quantize_serving_weights,
)

__all__ = [
    "ctc_loss",
    "ctc_loss_kernel",
    "debug_masks",
    "fast_dropout",
    "fast_dropout_add",
    "ffn_residual",
    "flash_mhsa",
    "fused_conformer_block",
    "fused_conformer_stack",
    "fused_conv_group_stack",
    "fused_squeezeformer_block",
    "fused_squeezeformer_stack",
    "mask_to_bias",
    "quantize_serving_weights",
    "reference_mhsa",
    "selection",
    "site_seed_table",
    "site_seeds",
]
