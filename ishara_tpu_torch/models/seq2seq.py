"""Encoder-decoder translation model (port of ``ishara_tpu/models/
seq2seq.py``), eval and training mode, and its loss.

Grouped feature extraction -> RoPE Squeezeformer (or Conformer) encoder ->
pre-norm causal transformer decoder, plus a confidence head on encoder
position 0. Tensors are ``[B, T, C]``; parameter names follow the flax
modules' so :mod:`ishara_tpu_torch.bridge` carries the JAX variables across
(``squeezeformer_layers_{i}`` / ``decoder_layers_{i}`` become
``squeezeformer_layers.{i}`` / ``decoder_layers.{i}``, a block's shared
residual ``scale`` stays ``scale``, the target embedding's ``embedding``
stays ``[C, d]``).

The reference's details that move numbers are kept:

* the per-group :class:`FeatureExtractor` convolves over the landmark axis
  (kernel 3, 'SAME'), BatchNorm eps 1e-3, relu, then the *mean over
  landmarks* and Dense(d / 4);
* :func:`rope_tables` divides by ``max(half - 1, 1)``, and :func:`apply_rope`
  rotates the two halves of the head dim, not interleaved pairs;
* attention scores are scaled by ``Dh**-0.5`` (not the CTC encoder's
  ``dim**-0.5``), and masked keys take ``finfo.min``, so an all-padding
  request gives uniform weights and no NaN;
* the conv module's BatchNorm uses eps 1e-5 (not the extractor's 1e-3);
* each encoder block has one learnable ``scale`` of shape (1,) that
  multiplies every residual branch; LayerNorms are f32 with eps 1e-6.

**Training mode** is an argument (``training=True``), as in the CTC
encoder (:mod:`.layers`): both BatchNorms take batch statistics -- the
extractor's over every ``B * T * L`` row, padded frames included, as the
reference does not mask them -- and move their running statistics in place
with flax's momentum convention (0.95 in the extractor, 0.9 in the conv
module). Every ``FastDropout`` site of the reference is a numbered
:class:`FastDropout` here: the attention probabilities after the masked
softmax (encoder, decoder self- and cross-attention), the block's
post-attention drop, the conv module's output, both drops of every
feed-forward and the target embedding's drop. The model numbers them once
at construction and :meth:`ASLTranslationModel.forward` makes the step's
table of their seeds from the step's dropout seed, so a step's masks are a
pure function of (seed, site), whichever device runs it; on the card each
site is the dropout kernel (K2). Attention stays the reference's einsum,
masked softmax and dropout: the CTC encoder's attention, feed-forward and
conv-module kernels compute other functions (RoPE and the ``Dh**-0.5``
scale, a GLU conv module with BN, a relu decoder FFN, one shared residual
``scale``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops.dropout import site_seed_table
from .layers import (
    BatchNorm,
    Conv,
    Dense,
    FastDropout,
    LayerNorm,
    number_dropout_sites,
)

LN_EPS = 1e-6
BN_EPS = 1e-3
BN_MOMENTUM = 0.95
ROPE_MAX_LEN = 384


class SameConv(Conv):
    """A 'SAME' convolution of odd kernel, dense or depthwise, on a
    channel-last ``[N, T, C]`` tensor, computed as one matrix product over
    the kernel's shifted copies (dense) or as a sum of shifted products
    (depthwise): the same function as ``F.conv1d``, whose weight gradient on
    the card may be summed by cuDNN with atomics in a run-to-run order; this
    one's is a matrix product or a plain reduction, the same bits every run,
    so that a resumed training run ends where the uninterrupted one did."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, groups=groups)
        if kernel_size % 2 != 1 or groups not in (1, in_channels):
            raise ValueError("SameConv takes an odd kernel, dense or "
                             "depthwise")

    def forward(self, x):
        w, K, T = self.weight, self.kernel_size[0], x.shape[1]
        xp = F.pad(x, (0, 0, K // 2, K // 2))
        taps = [xp[:, k:k + T] for k in range(K)]
        if self.groups == 1:              # [N, T, K * C] @ [K * C, out]
            y = torch.cat(taps, dim=-1) @ w.permute(2, 1, 0).reshape(
                -1, w.shape[0])
        else:
            y = sum(t * w[:, 0, k] for k, t in enumerate(taps))
        return y + self.bias


class FeatureExtractor(nn.Module):
    """[B, T, L, 3] group -> [B, T, out] frame features."""

    def __init__(self, out_dim: int = 52, hidden: int = 64):
        super().__init__()
        self.out_dim = out_dim
        self.conv = SameConv(3, hidden, 3)          # over the landmarks
        self.bn = BatchNorm(hidden, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.proj = Dense(hidden, out_dim)

    def forward(self, x, training: bool = False):
        B, T, L, C = x.shape
        h = F.relu(self.bn(self.conv(x.reshape(B * T, L, C)), training))
        return self.proj(h.mean(dim=1)).reshape(B, T, self.out_dim)


def rope_tables(head_dim: int, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Precomputed sin/cos for rotating half the head dim (numpy, as the
    reference computes them)."""
    half = head_dim // 2
    inv = np.exp(np.arange(half) * -(np.log(10000.0) / max(half - 1, 1)))
    ang = np.arange(max_len)[:, None] * inv[None, :]
    return np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)


def apply_rope(q, k, sin, cos):
    """Rotate the two halves of the head dim (half-split, not
    interleaved)."""
    def rot(x):
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot(q), rot(k)


def _masked(a, mask):
    """Scores where ``mask`` (broadcastable, True = visible), else
    ``finfo.min``."""
    return torch.where(mask, a, torch.finfo(a.dtype).min)


class RoPEMultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, dropout: float = 0.1,
                 max_len: int = ROPE_MAX_LEN):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q, self.k = Dense(dim, dim), Dense(dim, dim)
        self.v, self.out = Dense(dim, dim), Dense(dim, dim)
        self.attn_drop = FastDropout(dropout)
        sin, cos = rope_tables(dim // num_heads, max_len)
        self.register_buffer("sin", torch.from_numpy(sin), persistent=False)
        self.register_buffer("cos", torch.from_numpy(cos), persistent=False)

    def forward(self, x, mask=None, training: bool = False, seed=None):
        B, T, _ = x.shape
        H, Dh = self.num_heads, self.dim // self.num_heads
        q = self.q(x).reshape(B, T, H, Dh)
        k = self.k(x).reshape(B, T, H, Dh)
        v = self.v(x).reshape(B, T, H, Dh)
        sin = self.sin[:T][None, :, None, :]
        cos = self.cos[:T][None, :, None, :]
        q, k = apply_rope(q, k, sin, cos)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * (Dh ** -0.5)
        if mask is not None:
            attn = _masked(attn, mask[:, None, None, :])
        attn = self.attn_drop(torch.softmax(attn, dim=-1), training, seed)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, self.dim)
        return self.out(out)


class _ConvModule(nn.Module):
    """pw(2d) + GLU -> depthwise k=3 'SAME' -> BN (eps 1e-5, momentum 0.9)
    -> SiLU -> pw -> dropout."""

    def __init__(self, dim: int, dropout: float = 0.1):
        super().__init__()
        self.pw1 = SameConv(dim, 2 * dim, 1)
        self.dw = SameConv(dim, dim, 3, groups=dim)
        self.bn = BatchNorm(dim, eps=1e-5, momentum=0.9)
        self.pw2 = SameConv(dim, dim, 1)
        self.drop = FastDropout(dropout)

    def forward(self, x, training: bool = False, seed=None):
        a, b = torch.chunk(self.pw1(x), 2, dim=-1)
        h = F.silu(self.bn(self.dw(a * torch.sigmoid(b)), training))
        return self.drop(self.pw2(h), training, seed)


class _FF(nn.Module):
    def __init__(self, dim: int, dropout: float = 0.1):
        super().__init__()
        self.fc1, self.fc2 = Dense(dim, 4 * dim), Dense(4 * dim, dim)
        self.drop1, self.drop2 = FastDropout(dropout), FastDropout(dropout)

    def forward(self, x, training: bool = False, seed=None):
        h = self.drop1(F.silu(self.fc1(x)), training, seed)
        return self.drop2(self.fc2(h), training, seed)


class RoPESqueezeformerBlock(nn.Module):
    """FF1 -> RoPE-MHSA -> conv -> FF2, every residual branch scaled by one
    shared learnable scalar."""

    def __init__(self, dim: int, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.ff1_norm, self.ff1 = LayerNorm(dim, LN_EPS), _FF(dim, dropout)
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.mhsa = RoPEMultiHeadAttention(dim, num_heads, dropout)
        self.mhsa_drop = FastDropout(dropout)
        self.conv_norm = LayerNorm(dim, LN_EPS)
        self.conv = _ConvModule(dim, dropout)
        self.ff2_norm, self.ff2 = LayerNorm(dim, LN_EPS), _FF(dim, dropout)

    def forward(self, x, mask=None, training: bool = False, seed=None):
        s, t = self.scale, (training, seed)
        x = x + self.ff1(self.ff1_norm(x), *t) * s
        h = self.mhsa(self.norm1(x), mask, *t)
        x = x + self.mhsa_drop(h, *t) * s
        x = x + self.conv(self.conv_norm(x), *t) * s
        return x + self.ff2(self.ff2_norm(x), *t) * s


class RoPEConformerBlock(nn.Module):
    """MHSA -> conv module -> FFN (one 4x FFN), every residual branch scaled
    by one shared learnable scalar."""

    def __init__(self, dim: int, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.mhsa = RoPEMultiHeadAttention(dim, num_heads, dropout)
        self.mhsa_drop = FastDropout(dropout)
        self.conv_norm = LayerNorm(dim, LN_EPS)
        self.conv = _ConvModule(dim, dropout)
        self.ff_norm, self.ff = LayerNorm(dim, LN_EPS), _FF(dim, dropout)

    def forward(self, x, mask=None, training: bool = False, seed=None):
        s, t = self.scale, (training, seed)
        h = self.mhsa(self.norm1(x), mask, *t)
        x = x + self.mhsa_drop(h, *t) * s
        x = x + self.conv(self.conv_norm(x), *t) * s
        return x + self.ff(self.ff_norm(x), *t) * s


class DecoderLayer(nn.Module):
    """Pre-norm transformer decoder layer: causal self-attention,
    cross-attention, relu FFN (hidden 4d).

    ``forward`` runs over a full target prefix; ``step`` runs one token
    against carried self-attention K/V caches and the precomputed
    cross-attention K/V of :meth:`cross_kv` (eval mode only)."""

    def __init__(self, dim: int, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.sa_q, self.sa_k = Dense(dim, dim), Dense(dim, dim)
        self.sa_v, self.sa_out = Dense(dim, dim), Dense(dim, dim)
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.ca_q, self.ca_k = Dense(dim, dim), Dense(dim, dim)
        self.ca_v, self.ca_out = Dense(dim, dim), Dense(dim, dim)
        self.norm3 = LayerNorm(dim, LN_EPS)
        self.fc1, self.fc2 = Dense(dim, 4 * dim), Dense(4 * dim, dim)
        self.sa_drop, self.ca_drop = FastDropout(dropout), FastDropout(dropout)
        self.ff_drop1 = FastDropout(dropout)
        self.ff_drop2 = FastDropout(dropout)

    def _shape(self, x):
        B, S, _ = x.shape
        return x.reshape(B, S, self.num_heads, self.dim // self.num_heads)

    def cross_kv(self, memory):
        """Cross-attention K/V [B, T, H, Dh], computed once per sequence."""
        return self._shape(self.ca_k(memory)), self._shape(self.ca_v(memory))

    def _ffn(self, tgt, training=False, seed=None):
        h = self.ff_drop1(F.relu(self.fc1(self.norm3(tgt))), training, seed)
        return tgt + self.ff_drop2(self.fc2(h), training, seed)

    def _attend(self, q, k, v, visible, drop=None, training=False,
                seed=None):
        B, S = q.shape[:2]
        Dh = self.dim // self.num_heads
        a = torch.einsum("bqhd,bkhd->bhqk", q, k) * (Dh ** -0.5)
        if visible is not None:
            a = _masked(a, visible)
        a = torch.softmax(a, dim=-1)
        if drop is not None:
            a = drop(a, training, seed)
        return torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, self.dim)

    def _cross(self, tgt, k, v, memory_mask, training=False, seed=None):
        q = self._shape(self.ca_q(self.norm2(tgt)))
        vis = None if memory_mask is None else memory_mask[:, None, None, :]
        return tgt + self.ca_out(self._attend(q, k, v, vis, self.ca_drop,
                                              training, seed))

    def forward(self, tgt, memory, memory_mask=None, training: bool = False,
                seed=None):
        S = tgt.shape[1]
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                       device=tgt.device))
        h = self.norm1(tgt)
        q, k, v = (self._shape(self.sa_q(h)), self._shape(self.sa_k(h)),
                   self._shape(self.sa_v(h)))
        tgt = tgt + self.sa_out(self._attend(q, k, v, causal[None, None],
                                             self.sa_drop, training, seed))
        k, v = self.cross_kv(memory)
        tgt = self._cross(tgt, k, v, memory_mask, training, seed)
        return self._ffn(tgt, training, seed)

    def step(self, tgt, pos: int, k_cache, v_cache, k_cross, v_cross,
             memory_mask=None):
        """One decode step. ``tgt`` [B, 1, d] is the embedding at position
        ``pos``; caches are [B, S_max, H, Dh]. Writes cache row ``pos`` in
        place (where the reference returns updated copies) and returns
        (out [B, 1, d], k_cache, v_cache)."""
        S_max = k_cache.shape[1]
        h = self.norm1(tgt)
        q = self._shape(self.sa_q(h))
        k_cache[:, pos] = self._shape(self.sa_k(h))[:, 0]
        v_cache[:, pos] = self._shape(self.sa_v(h))[:, 0]
        visible = (torch.arange(S_max, device=tgt.device) <= pos)
        tgt = tgt + self.sa_out(self._attend(q, k_cache, v_cache,
                                             visible[None, None, None, :]))
        tgt = self._cross(tgt, k_cross, v_cross, memory_mask)
        return self._ffn(tgt), k_cache, v_cache


class Embed(nn.Module):
    """flax ``nn.Embed``: a table ``embedding`` [num, dim] (not transposed
    by the bridge), looked up by id."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(num, dim) / dim ** 0.5)

    def forward(self, ids):
        return self.embedding[ids.long()]


_BLOCKS = {"squeezeformer": RoPESqueezeformerBlock,
           "conformer": RoPEConformerBlock}


class ASLTranslationModel(nn.Module):
    """Grouped feature extraction -> RoPE encoder -> causal transformer
    decoder + confidence head.

    ``forward(x, mask, tgt)``: x [B, T, 92, 3] grouped landmarks, mask
    [B, T] bool (True = valid frame), tgt token ids [B, S] or None (None:
    the classifier over the encoder states). :meth:`encode` and
    :meth:`decode` are separate so an autoregressive decode runs the encoder
    once; :meth:`cross_kv` and :meth:`decode_step` are the KV-cached serving
    decode's pieces.

    ``forward(..., training=True, seed=...)`` is the training forward:
    batch statistics in both BatchNorms and dropout at ``dropout`` with the
    masks of the step's dropout ``seed`` (an int32 ``[1]`` tensor, as
    :func:`ishara_tpu_torch.ops.dropout.step_seeds` gives it); ``encode``
    and ``decode`` take the table of the sites' seeds that ``forward``
    makes from it."""

    def __init__(self, num_classes: int = 62, feature_dim: int = 208,
                 num_layers: int = 2, num_decoder_layers: int = 2,
                 num_heads: int = 8, dropout: float = 0.1,
                 encoder_type: str = "squeezeformer"):
        super().__init__()
        if encoder_type not in _BLOCKS:
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        d = feature_dim
        self.num_classes, self.feature_dim = num_classes, feature_dim
        self.num_layers, self.num_decoder_layers = num_layers, \
            num_decoder_layers
        self.num_heads, self.encoder_type = num_heads, encoder_type
        self.dropout = float(dropout)
        self.face_extractor = FeatureExtractor(d // 4)
        self.rhand_extractor = FeatureExtractor(d // 4)
        self.lhand_extractor = FeatureExtractor(d // 4)
        self.pose_extractor = FeatureExtractor(d // 4)
        self.squeezeformer_layers = nn.ModuleList(
            _BLOCKS[encoder_type](d, num_heads, dropout)
            for _ in range(num_layers))
        self.confidence_head = Dense(d, 1)
        self.target_embedding = Embed(num_classes, d)
        self.emb_dropout = FastDropout(dropout)
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(d, num_heads, dropout)
            for _ in range(num_decoder_layers))
        self.decoder_norm = LayerNorm(d, LN_EPS)
        self.classifier = Dense(d, num_classes)
        self.num_sites = number_dropout_sites(self)

    def encode(self, x, mask=None, training: bool = False, seed=None):
        """x [B, T, 92, 3] -> (memory [B, T, d], confidence [B]); the
        confidence reads encoder position 0 whatever the mask says."""
        # group slices: lip | rhand | lhand | rpose + lpose
        enc = torch.cat([
            self.face_extractor(x[:, :, 0:40], training),
            self.rhand_extractor(x[:, :, 40:61], training),
            self.lhand_extractor(x[:, :, 61:82], training),
            self.pose_extractor(x[:, :, 82:92], training),
        ], dim=-1)
        for layer in self.squeezeformer_layers:
            enc = layer(enc, mask, training, seed)
        return enc, self.confidence_head(enc[:, 0])[..., 0].float()

    def decode(self, tgt, memory, memory_mask=None, training: bool = False,
               seed=None):
        """tgt ids [B, S] + memory -> logits [B, S, num_classes] (f32)."""
        dec = self.emb_dropout(self.target_embedding(tgt), training, seed)
        for layer in self.decoder_layers:
            dec = layer(dec, memory, memory_mask, training, seed)
        return self.classifier(self.decoder_norm(dec)).float()

    def cross_kv(self, memory):
        """Per-layer cross-attention K/V, once per sequence."""
        return [layer.cross_kv(memory) for layer in self.decoder_layers]

    def decode_step(self, tok, pos: int, caches, cross, memory_mask=None):
        """One cached decode step: ``tok`` [B] ids at position ``pos`` ->
        (logits [B, num_classes], caches). ``caches`` is a per-layer list of
        (k_cache, v_cache) [B, S_max, H, Dh], written in place; ``cross``
        the output of :meth:`cross_kv`."""
        dec = self.target_embedding(tok[:, None])
        new_caches = []
        for layer, (kc, vc), (kx, vx) in zip(self.decoder_layers, caches,
                                             cross):
            dec, kc, vc = layer.step(dec, pos, kc, vc, kx, vx,
                                     memory_mask=memory_mask)
            new_caches.append((kc, vc))
        logits = self.classifier(self.decoder_norm(dec))[:, 0].float()
        return logits, new_caches

    def forward(self, x, mask=None, tgt=None, training: bool = False,
                seed=None):
        if training and seed is not None:
            # every site's seeds in one generator pass
            seed = site_seed_table(seed, self.num_sites)
        enc, confidence = self.encode(x, mask, training, seed)
        if tgt is not None:
            return self.decode(tgt, enc, mask, training, seed), confidence
        return self.classifier(enc).float(), confidence


def translation_loss(logits: torch.Tensor, targets: torch.Tensor,
                     confidence: torch.Tensor,
                     confidence_target: torch.Tensor, pad_idx: int = 0,
                     conf_weight: float = 0.1,
                     ce_denominator: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Cross-entropy over the non-pad targets plus ``conf_weight`` times the
    mean squared error of the confidence. The token sum is divided by
    ``ce_denominator`` when given (a data-parallel step's share of the
    global count), else by this batch's token count (at least 1)."""
    valid = (targets != pad_idx).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if ce_denominator is None:
        ce_denominator = torch.clamp(valid.sum(), min=1.0)
    ce = (nll * valid).sum() / ce_denominator
    mse = ((confidence - confidence_target) ** 2).mean()
    return ce + conf_weight * mse


def build_translation_model(device=None, **kw) -> ASLTranslationModel:
    """An eval-mode :class:`ASLTranslationModel` (keyword arguments as its
    constructor's) on ``device`` (default ``cuda``; raises when no card is
    visible)."""
    from ..device import resolve_device

    return ASLTranslationModel(**kw).to(resolve_device(device)).eval()
