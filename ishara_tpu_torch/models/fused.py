"""The whole eval forward of an encoder through the fused block kernels
(port of ``fused_encoder_forward`` of ``ishara_tpu/ops/fused_block.py``).

:class:`FusedEncoder` runs stem, the block stacks of
:mod:`ishara_tpu_torch.ops.fused_block`, top and classifier on one sequence,
with the stem and head as plain ``torch.matmul``, as the reference leaves them
to XLA outside any kernel. It is here, not beside the kernels, because it
reads the model's configuration and ``state_dict``: the kernels' package
knows nothing of the models.
"""

from __future__ import annotations

import torch

from ..bridge import conv1d_block_args, dequantize, is_quantized
from ..config import BN_EPS, EncoderConfig
from ..device import resolve_device
from ..ops.fused_block import (
    INNER,
    _mm,
    fused_conformer_stack,
    fused_conv_group_stack,
    fused_squeezeformer_stack,
    stack_group_args,
)
from ..preprocess.pipeline import frame_mask
from .encoder import block_counts, check_variant
from .layers import positional_encoding


def _storage_dtype(compute_dtype):
    if compute_dtype in (torch.bfloat16, torch.float32, "int8"):
        return compute_dtype
    raise ValueError(f'compute_dtype must be torch.bfloat16, torch.float32 '
                     f'or "int8", got {compute_dtype!r}')


def _head_matrix(sd, key, dt):
    """Stem, top or classifier weight [out, in] for a ``torch.matmul``
    outside the kernels: f32 [in, out], or at int8 the pair (q as f32
    [in, out], scale [out]) that :func:`_mm` scales after the dot."""
    w = sd[key]
    if dt == "int8":
        if not is_quantized(w):
            raise ValueError(
                f'compute_dtype="int8" requires weights quantized with '
                f"quantize_serving_weights; {key} is not")
        return (w["q"].T.to(torch.float32).contiguous(),
                w["scale"].to(torch.float32))
    return dequantize(w).T.contiguous()


_CONV_PREFIX = {"squeezeformer": "conv_squeeze", "conformer": "conv_conform",
                "transformer": "conv_t"}


def encoder_segment_args(cfg: EncoderConfig, sd, kind: str, dt):
    """The stacked kernel arguments ``(conv, inner)`` of the ``kind``
    segment ("squeezeformer", "conformer" or "transformer") of an
    ``IsharaEncoder`` ``state_dict`` at storage ``dt``; ``conv`` is () for
    the families without Conv1DBlocks."""
    n = dict(zip(INNER, block_counts(cfg)))[kind]
    nconv = cfg.num_conv_per_block \
        if cfg.variant in ("conv_hybrid", "conv_transformer") else 0
    return stack_group_args([
        (tuple(conv1d_block_args(sd, f"{_CONV_PREFIX[kind]}.{i}.{j}.", dt)
               for j in range(nconv)),
         INNER[kind][2](sd, f"{kind}.{i}.", dt))
        for i in range(n)])


class FusedEncoder:
    """Batch-1 eval forward of an ``IsharaEncoder`` through the fused block
    kernels, with the weights packed once for the kernels.

    ``state_dict`` is the port's ``IsharaEncoder`` state (bridged or its
    own); ``compute_dtype`` is the matmul-weight storage inside the blocks:
    bf16 (the default, the reference's deploy numerics), f32, or "int8", for
    which ``state_dict`` must come from :func:`quantize_serving_weights`.
    ``dma=True`` runs each stack as one persistent kernel."""

    def __init__(self, cfg: EncoderConfig, state_dict, *,
                 compute_dtype=torch.bfloat16, dma: bool = False,
                 device=None):
        check_variant(cfg)
        dev = resolve_device(device)
        dt = _storage_dtype(compute_dtype)

        def on_dev(v):
            if is_quantized(v):
                return {k: t.detach().to(dev) for k, t in v.items()}
            return v.detach().to(dev)

        sd = {k: on_dev(v) for k, v in state_dict.items()}
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        f32 = torch.float32
        self.stem_w = _head_matrix(sd, "stem_conv.weight", dt)
        self.pos = torch.as_tensor(positional_encoding(cfg.frame_len, cfg.dim),
                                   device=dev)
        self.bn = [sd[f"stem_bn.{n}"].to(f32) for n in
                   ("running_mean", "running_var", "weight", "bias")]
        # the reference hands dma to the squeezeformer, conformer and
        # conv_hybrid stacks but not to the conv_transformer one (its
        # fused_encoder_forward), and so does this
        self.segments = [
            (kind, encoder_segment_args(cfg, sd, kind, dt),
             dma and kind != "transformer")
            for kind, n in zip(INNER, block_counts(cfg)) if n]
        self.top_w = _head_matrix(sd, "top_conv.weight", dt)
        self.top_b = sd["top_conv.bias"].to(f32)
        self.cls_w = _head_matrix(sd, "classifier.weight", dt)
        self.cls_b = sd["classifier.bias"].to(f32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [T, input_dim] preprocessed frames -> logits [T, num_classes]."""
        mask = frame_mask(x)
        h = _mm(x, self.stem_w) + self.pos[: x.shape[0]]
        m, v, g, b = self.bn
        h = ((h - m) * torch.rsqrt(v + BN_EPS) * g + b).contiguous()
        for kind, groups, dma in self.segments:
            if groups[0]:  # a conv family: Conv1DBlocks before each block
                h = fused_conv_group_stack(h, mask, groups, kind,
                                           num_heads=self.num_heads, dma=dma)
            elif kind == "squeezeformer":
                h = fused_squeezeformer_stack(h, mask, groups[1],
                                              num_heads=self.num_heads,
                                              dma=dma)
            else:
                h = fused_conformer_stack(h, mask, groups[1],
                                          num_heads=self.num_heads, dma=dma)
        h = torch.relu(_mm(h, self.top_w) + self.top_b)
        return _mm(h, self.cls_w) + self.cls_b


def fused_encoder_forward(cfg: EncoderConfig, state_dict, x, *,
                          compute_dtype=torch.bfloat16, dma: bool = False,
                          device=None):
    """One-shot form of :class:`FusedEncoder`: x [T, input_dim] -> logits.
    Matches ``IsharaEncoder`` eval logits exactly up to f32 rounding at
    ``compute_dtype=torch.float32`` and to about 1% at bf16 and int8 (int8
    against the model on the dequantized weights)."""
    enc = FusedEncoder(cfg, state_dict, compute_dtype=compute_dtype, dma=dma,
                       device=device)
    return enc(torch.as_tensor(x).to(resolve_device(device)))
