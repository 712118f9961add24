"""The Ishara encoder (port of ``ishara_tpu/models/encoder.py``): stem ->
block stack -> CTC head, for the ``squeezeformer``, ``conformer``,
``hybrid``, ``conv_hybrid``, ``conv_transformer`` and ``parallel_branches``
families -- the attention-block ones also causal -- and, through
:func:`build_model`, the Temporal U-Net ``squeezeformer_unet``; eval and
training mode, at float32 or bfloat16 compute. :func:`get_model` is the
reference's parameterized constructor."""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import EncoderConfig
from ..device import resolve_device
from ..ops.dropout import site_seed_table
from ..preprocess.pipeline import frame_mask
from .blocks import (
    Conv1DBlock,
    ConformerBlock,
    SqueezeformerBlock,
    TransformerBlock,
)
from .layers import (
    BN_EPS,
    BN_MOMENTUM,
    BatchNorm,
    Dense,
    FastDropout,
    compute_dtype,
    frozen_running_stats,
    number_dropout_sites,
    positional_encoding,
)

ATTENTION_VARIANTS = ("squeezeformer", "conformer", "hybrid")
CONV_VARIANTS = ("conv_hybrid", "conv_transformer")
# the families the fused serving kernels cover (bidirectional only)
FUSED_VARIANTS = ATTENTION_VARIANTS + CONV_VARIANTS
VARIANTS = FUSED_VARIANTS + ("parallel_branches", "squeezeformer_unet")


def check_variant(cfg: EncoderConfig) -> None:
    """Raise for a configuration the port does not cover, or one the
    reference itself refuses."""
    if cfg.variant not in VARIANTS:
        raise ValueError(f"unknown variant {cfg.variant!r}")
    if cfg.causal and cfg.variant not in ATTENTION_VARIANTS:
        raise ValueError(
            f"causal/streaming mode supports the attention-block families, "
            f"not {cfg.variant!r} (the conv families' ECA gate is "
            f"whole-sequence)")
    compute_dtype(cfg.dtype)


def check_fused(cfg: EncoderConfig) -> None:
    """Raise ValueError unless the fused serving kernels implement ``cfg``:
    a bidirectional model of an attention or conv-interleaved family (the
    kernels apply full attention and the whole-sequence SE gate)."""
    check_variant(cfg)
    if cfg.variant not in FUSED_VARIANTS:
        raise ValueError(f"fused path covers the attention and conv-"
                         f"interleaved families, not {cfg.variant!r}")
    if cfg.causal:
        raise ValueError("fused serving kernels do not implement "
                         "cfg.causal semantics; use InferenceEngine("
                         "fused=False) or serve.StreamingEncoder")


def block_counts(cfg: EncoderConfig) -> tuple[int, int, int]:
    """(Squeezeformer, Conformer, Transformer) block counts of ``cfg``'s
    family; ``conv_transformer`` takes its count from
    ``num_squeeze_blocks`` as the reference does."""
    v = cfg.variant
    nsq = cfg.num_squeeze_blocks if v in ("squeezeformer", "hybrid",
                                          "conv_hybrid",
                                          "parallel_branches") else 0
    ncf = cfg.num_conform_blocks if v in ("conformer", "hybrid",
                                          "conv_hybrid",
                                          "parallel_branches") else 0
    ntr = cfg.num_squeeze_blocks if v == "conv_transformer" else 0
    return nsq, ncf, ntr


class IsharaEncoder(nn.Module):
    """[B, T, input_dim] landmarks -> [B, T, num_classes] CTC logits.

    Stem: Masking(0.0) -> biasless Linear -> + fixed sin/cos PE ->
    BatchNorm; then the block stack; then Linear(dim*top_mult, relu) ->
    top dropout -> Linear(num_classes). Computes in ``cfg.dtype`` with
    float32 parameters (see :mod:`.layers`) and returns float32 logits.

    ``forward(x, training=True, seed=...)`` is the training forward: batch
    statistics in every BatchNorm (whose running statistics move in place),
    dropout at ``cfg.dropout`` / ``cfg.top_dropout`` with the masks of the
    step's dropout ``seed``.

    With ``cfg.remat`` each Squeezeformer, Conformer and Transformer block
    of a training forward runs under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward pass
    instead of stored, as the reference's ``nn.remat`` does (the conv
    groups, the stem and the head are not wrapped). The recomputation draws
    the same dropout masks -- a function of (seed, site, position) -- and
    leaves the BatchNorm running statistics where the forward put them.

    ``parallel_branches`` runs the Conformer blocks and the Squeezeformer
    blocks side by side from the stem's output and joins them as
    ``merge(concat([conformer, squeezeformer], -1))``. With ``cfg.causal``
    the attention-block families take ``cfg.attn_context`` as their
    attention window."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        check_variant(cfg)
        if cfg.variant == "squeezeformer_unet":
            raise ValueError("unknown variant 'squeezeformer_unet' for "
                             "IsharaEncoder; build_model builds it")
        self.cfg = cfg
        causal = dict(causal=cfg.causal,
                      attn_context=cfg.attn_context if cfg.causal else 0)
        d = cfg.dim
        dt = compute_dtype(cfg.dtype)
        drop = cfg.dropout
        self.stem_conv = Dense(cfg.input_dim, d, bias=False, dtype=dt)
        self.register_buffer(
            "pos_enc",
            torch.as_tensor(positional_encoding(cfg.frame_len, d)),
            persistent=False)
        self.stem_bn = BatchNorm(d, eps=BN_EPS, momentum=BN_MOMENTUM,
                                 dtype=dt)
        nsq, ncf, ntr = block_counts(cfg)
        self.squeezeformer = nn.ModuleList(
            SqueezeformerBlock(d, cfg.num_heads, cfg.expansion_factor,
                               cfg.transformer_kernel_size, drop, dtype=dt,
                               use_flash=cfg.use_flash, **causal)
            for _ in range(nsq))
        self.conformer = nn.ModuleList(
            ConformerBlock(d, cfg.num_heads, cfg.expansion_factor,
                           cfg.transformer_kernel_size, drop, drop, dtype=dt,
                           use_flash=cfg.use_flash, **causal)
            for _ in range(ncf))
        self.transformer = nn.ModuleList(
            TransformerBlock(d, cfg.num_heads, cfg.expansion_factor, drop,
                             drop, dtype=dt, use_flash=cfg.use_flash)
            for _ in range(ntr))

        def conv_stacks(n):
            """One stack of num_conv_per_block Conv1DBlocks before each of
            ``n`` attention blocks (none for the families without them)."""
            if cfg.variant not in CONV_VARIANTS:
                n = 0
            return nn.ModuleList(
                nn.ModuleList(
                    Conv1DBlock(d, d, cfg.kernel_sizes[
                        j % len(cfg.kernel_sizes)], drop_rate=drop, dtype=dt)
                    for j in range(cfg.num_conv_per_block))
                for _ in range(n))

        self.conv_squeeze = conv_stacks(nsq)
        self.conv_conform = conv_stacks(ncf)
        self.conv_t = conv_stacks(ntr)
        self.merge = Dense(2 * d, d, dtype=dt) \
            if cfg.variant == "parallel_branches" else None
        self.top_conv = Dense(d, d * cfg.top_mult, dtype=dt)
        self.top_drop = FastDropout(cfg.top_dropout)
        self.classifier = Dense(d * cfg.top_mult, cfg.num_classes, dtype=dt)
        self.num_sites = number_dropout_sites(self)

    def forward(self, x, training: bool = False, seed=None):
        if training and seed is not None:
            # every site's seeds in one generator pass
            seed = site_seed_table(seed, self.num_sites)
        mask = frame_mask(x)
        x = self.stem_conv(x)
        x = x + self.pos_enc[: x.shape[1]].to(x.dtype)
        x = self.stem_bn(x, training)
        if self.merge is not None:
            a = b = x
            for blk in self.conformer:
                a = self._block(blk, a, mask, training, seed)
            for blk in self.squeezeformer:
                b = self._block(blk, b, mask, training, seed)
            x = self.merge(torch.cat([a, b], dim=-1))
            return self._head(x, training, seed)
        for convs, blocks in ((self.conv_squeeze, self.squeezeformer),
                              (self.conv_conform, self.conformer),
                              (self.conv_t, self.transformer)):
            for i, blk in enumerate(blocks):
                for conv in (convs[i] if len(convs) else ()):
                    x = conv(x, mask, training, seed)
                x = self._block(blk, x, mask, training, seed)
        return self._head(x, training, seed)

    def _block(self, blk, x, mask, training, seed):
        if self.cfg.remat and training and torch.is_grad_enabled():
            return checkpoint(blk, x, mask, training, seed,
                              use_reentrant=False,
                              context_fn=_remat_contexts)
        return blk(x, mask, training, seed)

    def _head(self, x, training, seed):
        x = self.top_drop(torch.relu(self.top_conv(x)), training, seed)
        return self.classifier(x).to(torch.float32)


def _remat_contexts():
    """The contexts of a ``remat`` block's forward and of its
    recomputation: the recomputation does not move BatchNorm's running
    statistics a second time."""
    return contextlib.nullcontext(), frozen_running_stats()


class _SpeechUNetAdapter(nn.Module):
    """The Temporal U-Net Squeezeformer (:mod:`.squeezeformer_unet`) behind
    the :class:`IsharaEncoder` calling convention, so it trains, serves and
    exports through the same machinery: ``num_squeeze_blocks`` blocks (at
    least 2), time reduction at ``max(n // 3, 1)`` (at 0 when ``frame_len``
    is odd) and recovery at ``max(2 n // 3, 2)``. It returns log-probs;
    ``log_softmax`` is idempotent, so CTC and greedy decode are
    unaffected."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        from .squeezeformer_unet import Squeezeformer

        check_variant(cfg)
        self.cfg = cfg
        n = max(cfg.num_squeeze_blocks, 2)
        self.unet = Squeezeformer(
            num_classes=cfg.num_classes, dim=cfg.dim, num_layers=n,
            num_heads=cfg.num_heads,
            reduce_idx=max(n // 3, 1) if cfg.frame_len % 2 == 0 else 0,
            recover_idx=max(2 * n // 3, 2), dropout=cfg.dropout,
            input_dim=cfg.input_dim, dtype=compute_dtype(cfg.dtype))
        self.num_sites = number_dropout_sites(self)

    def forward(self, x, training: bool = False, seed=None):
        if training and seed is not None:
            seed = site_seed_table(seed, self.num_sites)
        return self.unet(x, frame_mask(x), training, seed)


def build_model(cfg: EncoderConfig, device=None) -> nn.Module:
    """The eval-mode model of any CTC family on ``device`` (default
    ``cuda``; raises when no card is visible), its weights from PyTorch's
    default init: :class:`_SpeechUNetAdapter` for ``squeezeformer_unet``,
    else :class:`IsharaEncoder`. The one constructor of the ``Trainer``,
    the engines and the bundles; load trained or bridged weights with
    ``load_state_dict``."""
    device = resolve_device(device)
    model = _SpeechUNetAdapter(cfg) if cfg.variant == "squeezeformer_unet" \
        else IsharaEncoder(cfg)
    return model.to(device).eval()


def get_model(dim: int = 256, num_conv_squeeze_blocks: int = 2,
              num_conv_conform_blocks: int = 2,
              kernel_sizes: tuple[int, ...] = (11, 5, 3),
              num_conv_per_block: int = 3, dropout_rate: float = 0.2,
              num_heads: int = 8, expansion_factor: int = 2,
              transformer_kernel_size: int = 15, variant: str = "conv_hybrid",
              device=None, **kwargs) -> IsharaEncoder:
    """The reference README's parameterized constructor: an eval-mode
    :class:`IsharaEncoder` on ``device`` (default ``cuda``). ``top_mult``
    is 2 for ``conv_hybrid`` and ``squeezeformer``, else 1; extra
    ``kwargs`` go to :class:`EncoderConfig`."""
    cfg = EncoderConfig(
        dim=dim, variant=variant,
        num_squeeze_blocks=num_conv_squeeze_blocks,
        num_conform_blocks=num_conv_conform_blocks,
        kernel_sizes=tuple(kernel_sizes),
        num_conv_per_block=num_conv_per_block, dropout=dropout_rate,
        num_heads=num_heads, expansion_factor=expansion_factor,
        transformer_kernel_size=transformer_kernel_size,
        top_mult=2 if variant in ("conv_hybrid", "squeezeformer") else 1,
        **kwargs)
    return IsharaEncoder(cfg).to(resolve_device(device)).eval()
