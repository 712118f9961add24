"""The port's kernels, each beside its plain PyTorch version: the training
kernels (:mod:`.ctc_kernel`, :mod:`.dropout`, :mod:`.attention`,
:mod:`.ffn_kernel`, and for long sequences :mod:`.attention_blocked` and
:mod:`.conv_kernel`), the serving block stacks (:mod:`.fused_block`) and the
translation model's whole-loop decode (:mod:`.decoder_kernel`). The model
package builds on this one; nothing here imports it."""

from . import selection
from .attention import flash_mhsa, mask_to_bias, reference_mhsa
from .attention_blocked import (
    blocked_attention_backward_plain,
    blocked_attention_forward_plain,
    flash_mhsa_blocked,
)
from .conv_kernel import (
    conv_module_backward_plain,
    conv_module_forward_plain,
    conv_module_residual,
)
from .ctc import ctc_loss
from .ctc_kernel import ctc_loss_kernel
from .decoder_kernel import (
    DecoderFitError,
    fused_beam_decode,
    fused_beam_translate,
    fused_decode_fits,
    fused_greedy_decode,
    fused_greedy_translate,
)
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
    "DecoderFitError",
    "blocked_attention_backward_plain",
    "blocked_attention_forward_plain",
    "conv_module_backward_plain",
    "conv_module_forward_plain",
    "conv_module_residual",
    "ctc_loss",
    "ctc_loss_kernel",
    "debug_masks",
    "fast_dropout",
    "fast_dropout_add",
    "ffn_residual",
    "fused_beam_decode",
    "fused_beam_translate",
    "flash_mhsa",
    "flash_mhsa_blocked",
    "fused_conformer_block",
    "fused_conformer_stack",
    "fused_conv_group_stack",
    "fused_decode_fits",
    "fused_greedy_decode",
    "fused_greedy_translate",
    "fused_squeezeformer_block",
    "fused_squeezeformer_stack",
    "mask_to_bias",
    "quantize_serving_weights",
    "reference_mhsa",
    "selection",
    "site_seed_table",
    "site_seeds",
]
