"""The Ishara encoder (port of ``ishara_tpu/models/encoder.py``): stem ->
block stack -> CTC head, for the ``squeezeformer``, ``conformer``,
``hybrid``, ``conv_hybrid`` and ``conv_transformer`` families, eval mode."""

from __future__ import annotations

import torch
from torch import nn

from ..config import EncoderConfig
from ..device import resolve_device
from ..preprocess.pipeline import frame_mask
from .blocks import (
    Conv1DBlock,
    ConformerBlock,
    SqueezeformerBlock,
    TransformerBlock,
)
from .layers import BN_EPS, BN_MOMENTUM, positional_encoding

ATTENTION_VARIANTS = ("squeezeformer", "conformer", "hybrid")
CONV_VARIANTS = ("conv_hybrid", "conv_transformer")
PORTED_VARIANTS = ATTENTION_VARIANTS + CONV_VARIANTS
UNPORTED_VARIANTS = ("parallel_branches", "squeezeformer_unet")


def check_variant(cfg: EncoderConfig) -> None:
    """Raise for a configuration the port does not cover, or one the
    reference itself refuses."""
    if cfg.variant in UNPORTED_VARIANTS:
        raise NotImplementedError(
            f"variant {cfg.variant!r} is not ported yet (ROADMAP.md Queue 1 "
            f"item 8, remaining encoder families)")
    if cfg.variant not in PORTED_VARIANTS:
        raise ValueError(f"unknown variant {cfg.variant!r}")
    if cfg.causal and cfg.variant in CONV_VARIANTS:
        raise ValueError(
            f"causal/streaming mode supports the attention-block families, "
            f"not {cfg.variant!r} (the conv families' ECA gate is "
            f"whole-sequence)")
    if cfg.causal:
        raise NotImplementedError(
            "causal mode is not ported yet (ROADMAP.md Queue 1 item 9, "
            "causal mode and streaming)")


def block_counts(cfg: EncoderConfig) -> tuple[int, int, int]:
    """(Squeezeformer, Conformer, Transformer) block counts of ``cfg``'s
    family; ``conv_transformer`` takes its count from
    ``num_squeeze_blocks`` as the reference does."""
    v = cfg.variant
    nsq = cfg.num_squeeze_blocks if v in ("squeezeformer", "hybrid",
                                          "conv_hybrid") else 0
    ncf = cfg.num_conform_blocks if v in ("conformer", "hybrid",
                                          "conv_hybrid") else 0
    ntr = cfg.num_squeeze_blocks if v == "conv_transformer" else 0
    return nsq, ncf, ntr


class IsharaEncoder(nn.Module):
    """[B, T, input_dim] landmarks -> [B, T, num_classes] CTC logits.

    Stem: Masking(0.0) -> biasless Linear -> + fixed sin/cos PE ->
    BatchNorm; then the block stack; then Linear(dim*top_mult, relu) ->
    Linear(num_classes). Computes in float32."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        check_variant(cfg)
        self.cfg = cfg
        d = cfg.dim
        self.stem_conv = nn.Linear(cfg.input_dim, d, bias=False)
        self.register_buffer(
            "pos_enc",
            torch.as_tensor(positional_encoding(cfg.frame_len, d)),
            persistent=False)
        self.stem_bn = nn.BatchNorm1d(d, eps=BN_EPS, momentum=BN_MOMENTUM)
        nsq, ncf, ntr = block_counts(cfg)
        self.squeezeformer = nn.ModuleList(
            SqueezeformerBlock(d, cfg.num_heads, cfg.expansion_factor,
                               cfg.transformer_kernel_size)
            for _ in range(nsq))
        self.conformer = nn.ModuleList(
            ConformerBlock(d, cfg.num_heads, cfg.expansion_factor,
                           cfg.transformer_kernel_size)
            for _ in range(ncf))
        self.transformer = nn.ModuleList(
            TransformerBlock(d, cfg.num_heads, cfg.expansion_factor)
            for _ in range(ntr))

        def conv_stacks(n):
            """One stack of num_conv_per_block Conv1DBlocks before each of
            ``n`` attention blocks (none for the families without them)."""
            if cfg.variant not in CONV_VARIANTS:
                n = 0
            return nn.ModuleList(
                nn.ModuleList(
                    Conv1DBlock(d, d, cfg.kernel_sizes[
                        j % len(cfg.kernel_sizes)])
                    for j in range(cfg.num_conv_per_block))
                for _ in range(n))

        self.conv_squeeze = conv_stacks(nsq)
        self.conv_conform = conv_stacks(ncf)
        self.conv_t = conv_stacks(ntr)
        self.top_conv = nn.Linear(d, d * cfg.top_mult)
        self.classifier = nn.Linear(d * cfg.top_mult, cfg.num_classes)

    def forward(self, x):
        mask = frame_mask(x)
        x = self.stem_conv(x.to(torch.float32))
        x = x + self.pos_enc[: x.shape[1]]
        x = self.stem_bn(x.transpose(1, 2)).transpose(1, 2)
        for convs, blocks in ((self.conv_squeeze, self.squeezeformer),
                              (self.conv_conform, self.conformer),
                              (self.conv_t, self.transformer)):
            for i, blk in enumerate(blocks):
                for conv in (convs[i] if len(convs) else ()):
                    x = conv(x, mask)
                x = blk(x, mask)
        return self.classifier(torch.relu(self.top_conv(x)))


def build_model(cfg: EncoderConfig, device=None) -> IsharaEncoder:
    """An eval-mode :class:`IsharaEncoder` on ``device`` (default ``cuda``;
    raises when no card is visible). Weights come from PyTorch's default
    init; load trained or bridged ones with ``load_state_dict``."""
    return IsharaEncoder(cfg).to(resolve_device(device)).eval()
