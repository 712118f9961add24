"""The Ishara encoder (port of ``ishara_tpu/models/encoder.py``): stem ->
block stack -> CTC head, for the ``squeezeformer``, ``conformer`` and
``hybrid`` families, eval mode."""

from __future__ import annotations

import torch
from torch import nn

from ..config import EncoderConfig
from ..device import resolve_device
from ..preprocess.pipeline import frame_mask
from .blocks import ConformerBlock, SqueezeformerBlock
from .layers import BN_EPS, BN_MOMENTUM, positional_encoding

PORTED_VARIANTS = ("squeezeformer", "conformer", "hybrid")


def check_variant(cfg: EncoderConfig) -> None:
    """Raise for a configuration this slice of the port does not cover."""
    if cfg.variant not in PORTED_VARIANTS:
        raise NotImplementedError(
            f"variant {cfg.variant!r} is not ported yet (ROADMAP.md Queue 1 "
            f"item 8, remaining encoder families)")
    if cfg.causal:
        raise NotImplementedError(
            "causal mode is not ported yet (ROADMAP.md Queue 1 item 9, "
            "causal mode and streaming)")


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
        nsq = cfg.num_squeeze_blocks if cfg.variant != "conformer" else 0
        ncf = cfg.num_conform_blocks if cfg.variant != "squeezeformer" else 0
        self.squeezeformer = nn.ModuleList(
            SqueezeformerBlock(d, cfg.num_heads, cfg.expansion_factor,
                               cfg.transformer_kernel_size)
            for _ in range(nsq))
        self.conformer = nn.ModuleList(
            ConformerBlock(d, cfg.num_heads, cfg.expansion_factor,
                           cfg.transformer_kernel_size)
            for _ in range(ncf))
        self.top_conv = nn.Linear(d, d * cfg.top_mult)
        self.classifier = nn.Linear(d * cfg.top_mult, cfg.num_classes)

    def forward(self, x):
        mask = frame_mask(x)
        x = self.stem_conv(x.to(torch.float32))
        x = x + self.pos_enc[: x.shape[1]]
        x = self.stem_bn(x.transpose(1, 2)).transpose(1, 2)
        for blk in self.squeezeformer:
            x = blk(x, mask)
        for blk in self.conformer:
            x = blk(x, mask)
        return self.classifier(torch.relu(self.top_conv(x)))


def build_model(cfg: EncoderConfig, device=None) -> IsharaEncoder:
    """An eval-mode :class:`IsharaEncoder` on ``device`` (default ``cuda``;
    raises when no card is visible). Weights come from PyTorch's default
    init; load trained or bridged ones with ``load_state_dict``."""
    return IsharaEncoder(cfg).to(resolve_device(device)).eval()
