"""Encoder-decoder translation model (port of ``ishara_tpu/models/
seq2seq.py``), eval mode.

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

Dropout is left out: the reference's sites are no-ops in eval mode, and
training this family is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv, Dense, LayerNorm

LN_EPS = 1e-6
BN_EPS = 1e-3
BN_MOMENTUM = 0.95
ROPE_MAX_LEN = 384


class FeatureExtractor(nn.Module):
    """[B, T, L, 3] group -> [B, T, out] frame features."""

    def __init__(self, out_dim: int = 52, hidden: int = 64):
        super().__init__()
        self.out_dim = out_dim
        self.conv = Conv(3, hidden, 3, padding=1)   # 'SAME' over landmarks
        self.bn = BatchNorm(hidden, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.proj = Dense(hidden, out_dim)

    def forward(self, x):
        B, T, L, C = x.shape
        h = F.relu(self.bn(self.conv(x.reshape(B * T, L, C))))
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
    def __init__(self, dim: int, num_heads: int = 8,
                 max_len: int = ROPE_MAX_LEN):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q, self.k = Dense(dim, dim), Dense(dim, dim)
        self.v, self.out = Dense(dim, dim), Dense(dim, dim)
        sin, cos = rope_tables(dim // num_heads, max_len)
        self.register_buffer("sin", torch.from_numpy(sin), persistent=False)
        self.register_buffer("cos", torch.from_numpy(cos), persistent=False)

    def forward(self, x, mask=None):
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
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, self.dim)
        return self.out(out)


class _ConvModule(nn.Module):
    """pw(2d) + GLU -> depthwise k=3 'SAME' -> BN (eps 1e-5) -> SiLU -> pw."""

    def __init__(self, dim: int):
        super().__init__()
        self.pw1 = Conv(dim, 2 * dim, 1)
        self.dw = Conv(dim, dim, 3, padding=1, groups=dim)
        self.bn = BatchNorm(dim, eps=1e-5, momentum=0.9)
        self.pw2 = Conv(dim, dim, 1)

    def forward(self, x):
        a, b = torch.chunk(self.pw1(x), 2, dim=-1)
        h = F.silu(self.bn(self.dw(a * torch.sigmoid(b))))
        return self.pw2(h)


class _FF(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1, self.fc2 = Dense(dim, 4 * dim), Dense(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class RoPESqueezeformerBlock(nn.Module):
    """FF1 -> RoPE-MHSA -> conv -> FF2, every residual branch scaled by one
    shared learnable scalar."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.ff1_norm, self.ff1 = LayerNorm(dim, LN_EPS), _FF(dim)
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.mhsa = RoPEMultiHeadAttention(dim, num_heads)
        self.conv_norm, self.conv = LayerNorm(dim, LN_EPS), _ConvModule(dim)
        self.ff2_norm, self.ff2 = LayerNorm(dim, LN_EPS), _FF(dim)

    def forward(self, x, mask=None):
        s = self.scale
        x = x + self.ff1(self.ff1_norm(x)) * s
        x = x + self.mhsa(self.norm1(x), mask=mask) * s
        x = x + self.conv(self.conv_norm(x)) * s
        return x + self.ff2(self.ff2_norm(x)) * s


class RoPEConformerBlock(nn.Module):
    """MHSA -> conv module -> FFN (one 4x FFN), every residual branch scaled
    by one shared learnable scalar."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.mhsa = RoPEMultiHeadAttention(dim, num_heads)
        self.conv_norm, self.conv = LayerNorm(dim, LN_EPS), _ConvModule(dim)
        self.ff_norm, self.ff = LayerNorm(dim, LN_EPS), _FF(dim)

    def forward(self, x, mask=None):
        s = self.scale
        x = x + self.mhsa(self.norm1(x), mask=mask) * s
        x = x + self.conv(self.conv_norm(x)) * s
        return x + self.ff(self.ff_norm(x)) * s


class DecoderLayer(nn.Module):
    """Pre-norm transformer decoder layer: causal self-attention,
    cross-attention, relu FFN (hidden 4d).

    ``forward`` runs over a full target prefix; ``step`` runs one token
    against carried self-attention K/V caches and the precomputed
    cross-attention K/V of :meth:`cross_kv`."""

    def __init__(self, dim: int, num_heads: int = 8):
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

    def _shape(self, x):
        B, S, _ = x.shape
        return x.reshape(B, S, self.num_heads, self.dim // self.num_heads)

    def cross_kv(self, memory):
        """Cross-attention K/V [B, T, H, Dh], computed once per sequence."""
        return self._shape(self.ca_k(memory)), self._shape(self.ca_v(memory))

    def _ffn(self, tgt):
        return tgt + self.fc2(F.relu(self.fc1(self.norm3(tgt))))

    def _attend(self, q, k, v, visible):
        B, S = q.shape[:2]
        Dh = self.dim // self.num_heads
        a = torch.einsum("bqhd,bkhd->bhqk", q, k) * (Dh ** -0.5)
        if visible is not None:
            a = _masked(a, visible)
        a = torch.softmax(a, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, self.dim)

    def _cross(self, tgt, k, v, memory_mask):
        q = self._shape(self.ca_q(self.norm2(tgt)))
        vis = None if memory_mask is None else memory_mask[:, None, None, :]
        return tgt + self.ca_out(self._attend(q, k, v, vis))

    def forward(self, tgt, memory, memory_mask=None):
        S = tgt.shape[1]
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                       device=tgt.device))
        h = self.norm1(tgt)
        q, k, v = (self._shape(self.sa_q(h)), self._shape(self.sa_k(h)),
                   self._shape(self.sa_v(h)))
        tgt = tgt + self.sa_out(self._attend(q, k, v, causal[None, None]))
        k, v = self.cross_kv(memory)
        return self._ffn(self._cross(tgt, k, v, memory_mask))

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
    decode's pieces."""

    def __init__(self, num_classes: int = 62, feature_dim: int = 208,
                 num_layers: int = 2, num_decoder_layers: int = 2,
                 num_heads: int = 8, encoder_type: str = "squeezeformer"):
        super().__init__()
        if encoder_type not in _BLOCKS:
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        d = feature_dim
        self.num_classes, self.feature_dim = num_classes, feature_dim
        self.num_layers, self.num_decoder_layers = num_layers, \
            num_decoder_layers
        self.num_heads, self.encoder_type = num_heads, encoder_type
        self.face_extractor = FeatureExtractor(d // 4)
        self.rhand_extractor = FeatureExtractor(d // 4)
        self.lhand_extractor = FeatureExtractor(d // 4)
        self.pose_extractor = FeatureExtractor(d // 4)
        self.squeezeformer_layers = nn.ModuleList(
            _BLOCKS[encoder_type](d, num_heads) for _ in range(num_layers))
        self.confidence_head = Dense(d, 1)
        self.target_embedding = Embed(num_classes, d)
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(d, num_heads) for _ in range(num_decoder_layers))
        self.decoder_norm = LayerNorm(d, LN_EPS)
        self.classifier = Dense(d, num_classes)

    def encode(self, x, mask=None):
        """x [B, T, 92, 3] -> (memory [B, T, d], confidence [B]); the
        confidence reads encoder position 0 whatever the mask says."""
        # group slices: lip | rhand | lhand | rpose + lpose
        enc = torch.cat([
            self.face_extractor(x[:, :, 0:40]),
            self.rhand_extractor(x[:, :, 40:61]),
            self.lhand_extractor(x[:, :, 61:82]),
            self.pose_extractor(x[:, :, 82:92]),
        ], dim=-1)
        for layer in self.squeezeformer_layers:
            enc = layer(enc, mask=mask)
        return enc, self.confidence_head(enc[:, 0])[..., 0].float()

    def decode(self, tgt, memory, memory_mask=None):
        """tgt ids [B, S] + memory -> logits [B, S, num_classes] (f32)."""
        dec = self.target_embedding(tgt)
        for layer in self.decoder_layers:
            dec = layer(dec, memory, memory_mask=memory_mask)
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

    def forward(self, x, mask=None, tgt=None):
        enc, confidence = self.encode(x, mask=mask)
        if tgt is not None:
            return self.decode(tgt, enc, memory_mask=mask), confidence
        return self.classifier(enc).float(), confidence


def build_translation_model(device=None, **kw) -> ASLTranslationModel:
    """An eval-mode :class:`ASLTranslationModel` (keyword arguments as its
    constructor's) on ``device`` (default ``cuda``; raises when no card is
    visible)."""
    from ..device import resolve_device

    return ASLTranslationModel(**kw).to(resolve_device(device)).eval()
