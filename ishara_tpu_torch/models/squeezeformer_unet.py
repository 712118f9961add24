"""Speech-style Squeezeformer with a Temporal U-Net (port of
``ishara_tpu/models/squeezeformer_unet.py``), eval and training mode.

* :class:`RelativeMultiHeadAttention` -- Transformer-XL relative attention
  with u / v content and position biases and the relative-shift trick;
  scores scaled by ``sqrt(dim)``, masked keys at ``finfo.min``;
* :class:`DepthwiseConv2dSubsampling` -- two stride-2 3x3 convs over (time,
  feature), x4 fewer frames;
* :class:`TimeReductionLayer` / :func:`recover_resolution` -- the Temporal
  U-Net: halve the time axis mid-stack, recover by a 2x repeat plus the
  skip;
* :class:`SpeechSqueezeformerEncoder` / :class:`Squeezeformer` -- post-LN
  blocks MHSA -> LN -> FFN -> LN -> Conv -> LN -> FFN -> LN, and the CTC
  head: a biasless Linear, then ``log_softmax`` in float32.

Every ``FastDropout`` is a dropout site (numbered by the model that holds
it, :func:`~.layers.number_dropout_sites`). The post-LN blocks' LayerNorms
have no compute dtype, as in the reference: they return float32 whatever
their input, so a bf16 model carries float32 activations between blocks
and rounds at each Linear.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import BN_EPS, LN_EPS
from .layers import BN_MOMENTUM, BatchNorm, Conv, Dense, FastDropout, LayerNorm


def rel_positional_encoding(T: int, dim: int) -> np.ndarray:
    """Relative positions ``T-1 .. -(T-1)``, [2T-1, dim], sin on the even
    channels and cos on the odd ones."""
    pos = np.arange(T - 1, -T, -1, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, np.float32) * -(np.log(10000.0) / dim))
    pe = np.zeros((2 * T - 1, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _xavier(shape) -> torch.Tensor:
    """flax's ``xavier_uniform`` for a 2-D parameter (fan_in = shape[0])."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape).uniform_(-limit, limit)


class RelativeMultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.compute_dtype = dtype
        dh = dim // num_heads
        self.q = Dense(dim, dim, dtype=dtype)
        self.k = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.pos = Dense(dim, dim, bias=False, dtype=dtype)
        self.u_bias = nn.Parameter(_xavier((num_heads, dh)))
        self.v_bias = nn.Parameter(_xavier((num_heads, dh)))
        self.drop = FastDropout(dropout)
        self.out = Dense(dim, dim, dtype=dtype)

    @staticmethod
    def _rel_shift(x: torch.Tensor) -> torch.Tensor:
        """[B, H, T, 2T-1] -> [B, H, T, T]: pad one column on the left,
        view as [L+1, T], drop the first row, view back, keep T columns."""
        B, H, T, L = x.shape
        x = F.pad(x, (1, 0)).reshape(B, H, L + 1, T)
        return x[:, :, 1:].reshape(B, H, T, L)[..., :T]

    def forward(self, x, mask=None, training: bool = False, seed=None):
        B, T, _ = x.shape
        H, Dh = self.num_heads, self.dim // self.num_heads
        dt = self.compute_dtype
        q = self.q(x).reshape(B, T, H, Dh)
        k = self.k(x).reshape(B, T, H, Dh)
        v = self.v(x).reshape(B, T, H, Dh)
        pe = torch.as_tensor(rel_positional_encoding(T, self.dim),
                             device=x.device).to(dt)
        p = self.pos(pe).reshape(2 * T - 1, H, Dh)
        # the biases are float32 parameters: adding them promotes the
        # queries, and the products, to float32 (as jnp's promotion does)
        f32 = torch.float32
        content = torch.einsum("bqhd,bkhd->bhqk", q + self.u_bias, k.to(f32))
        pos = torch.einsum("bqhd,lhd->bhql", q + self.v_bias, p.to(f32))
        score = (content + self._rel_shift(pos)) / math.sqrt(self.dim)
        if mask is not None:
            score = score.masked_fill(~mask[:, None, None, :],
                                      torch.finfo(score.dtype).min)
        attn = self.drop(score.softmax(dim=-1), training, seed)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v.to(f32))
        return self.out(out.reshape(B, T, self.dim))


class DepthwiseConv2dSubsampling(nn.Module):
    """[B, T, F] -> [B, T/4, (F/4) * out_dim]: a 3x3 stride-2 conv (1 ->
    out_dim channels) -> relu -> a depthwise 3x3 stride-2 conv -> relu,
    both with flax's ``SAME`` padding."""

    def __init__(self, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(1, out_dim, 3, stride=2)
        self.dwconv = nn.Conv2d(out_dim, out_dim, 3, stride=2,
                                groups=out_dim)

    def _conv(self, conv, h):
        dt = self.compute_dtype
        h = F.pad(h, _same_pad(h.shape[3], 3, 2) + _same_pad(h.shape[2], 3, 2))
        return F.conv2d(h.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                        stride=2, groups=conv.groups)

    def forward(self, x):
        h = torch.relu(self._conv(self.conv1, x[:, None]))  # [B, C, T/2, F/2]
        h = torch.relu(self._conv(self.dwconv, h))          # [B, C, T/4, F/4]
        B, C, T4, F4 = h.shape
        return h.permute(0, 2, 3, 1).reshape(B, T4, F4 * C)


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """flax / XLA ``SAME`` padding of an axis of ``n``: ``ceil(n / stride)``
    outputs, the smaller half of the padding on the left."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class TimeReductionLayer(nn.Module):
    """Depthwise stride-2 conv over time with flax's ``SAME`` padding
    (PyTorch's ``padding="same"`` refuses a stride): ``ceil(T/2)`` frames."""

    def __init__(self, dim: int, kernel_size: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = kernel_size
        self.dw = Conv(dim, dim, kernel_size, dtype=dtype, stride=2,
                       groups=dim)

    def forward(self, x):
        return self.dw(F.pad(x, (0, 0) + _same_pad(x.shape[1], self.k, 2)))


def recover_resolution(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """2x repeat along time, cropped to ``target_len`` frames (a broadcast,
    whose backward is a sum: ``repeat_interleave``'s adds with atomics on
    the card, in no fixed order)."""
    B, T, C = x.shape
    return x[:, :, None].expand(B, T, 2, C).reshape(B, 2 * T, C)[
        :, :target_len]


class _PostLNBlock(nn.Module):
    """MHSA -> LN -> FFN -> LN -> conv module -> LN -> FFN -> LN, each a
    post-norm residual; the conv module is pw(2 dim) + GLU -> 'same'
    depthwise conv -> BN -> swish -> pw(dim)."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 31,
                 expansion: int = 4, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        e = dim * expansion
        self.mhsa = RelativeMultiHeadAttention(dim, num_heads, dropout, dtype)
        f32 = torch.float32
        self.ln1 = LayerNorm(dim, eps=LN_EPS, dtype=f32)
        self.ffn1_fc1 = Dense(dim, e, dtype=dtype)
        self.ffn1_drop = FastDropout(dropout)
        self.ffn1_fc2 = Dense(e, dim, dtype=dtype)
        self.ln2 = LayerNorm(dim, eps=LN_EPS, dtype=f32)
        self.pw1 = Conv(dim, 2 * dim, 1, dtype=dtype)
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.dw = Conv(dim, dim, kernel_size, dtype=dtype, groups=dim)
        self.bn = BatchNorm(dim, eps=BN_EPS, momentum=BN_MOMENTUM, dtype=dtype)
        self.pw2 = Conv(dim, dim, 1, dtype=dtype)
        self.ln3 = LayerNorm(dim, eps=LN_EPS, dtype=f32)
        self.ffn2_fc1 = Dense(dim, e, dtype=dtype)
        self.ffn2_drop = FastDropout(dropout)
        self.ffn2_fc2 = Dense(e, dim, dtype=dtype)
        self.ln4 = LayerNorm(dim, eps=LN_EPS, dtype=f32)

    def forward(self, x, mask=None, training: bool = False, seed=None):
        def ffn(fc1, drop, fc2, h):
            return fc2(drop(F.silu(fc1(h)), training, seed))

        x = self.ln1(x + self.mhsa(x, mask, training, seed))
        x = self.ln2(x + ffn(self.ffn1_fc1, self.ffn1_drop, self.ffn1_fc2, x))
        a, b = self.pw1(x).split(self.dim, dim=-1)
        h = self.dw(F.pad(a * torch.sigmoid(b), (0, 0) + self.pad))
        h = self.pw2(F.silu(self.bn(h, training)))
        x = self.ln3(x + h)
        return self.ln4(x + ffn(self.ffn2_fc1, self.ffn2_drop, self.ffn2_fc2,
                                x))


class SpeechSqueezeformerEncoder(nn.Module):
    """The block stack: at block ``reduce_idx`` the time axis is halved (the
    input kept as the skip, the mask subsampled ``mask[:, ::2]``); at block
    ``recover_idx`` it is repeated back to full length, projected and added
    to the skip, and the full mask restored."""

    def __init__(self, dim: int = 144, num_layers: int = 8, num_heads: int = 4,
                 kernel_size: int = 31, reduce_idx: int = 3,
                 recover_idx: int = 6, dropout: float = 0.1,
                 subsample: bool = False, input_dim: int = 276,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reduce_idx, self.recover_idx = reduce_idx, recover_idx
        in_dim = input_dim
        self.subsample = None
        if subsample:
            self.subsample = DepthwiseConv2dSubsampling(dim, dtype=dtype)
            in_dim = _same_out(_same_out(input_dim)) * dim
        self.input_proj = Dense(in_dim, dim, dtype=dtype)
        reduces = 0 <= reduce_idx < num_layers
        self.time_reduce = TimeReductionLayer(dim, dtype=dtype) \
            if reduces else None
        self.recover_proj = Dense(dim, dim, dtype=dtype) \
            if reduces and reduce_idx <= recover_idx < num_layers else None
        self.block = nn.ModuleList(
            _PostLNBlock(dim, num_heads, kernel_size, dropout=dropout,
                         dtype=dtype)
            for _ in range(num_layers))

    def forward(self, x, mask=None, training: bool = False, seed=None):
        if self.subsample is not None:
            x = self.subsample(x)
            if mask is not None:
                mask = mask[:, ::2][:, ::2]
        x = self.input_proj(x)
        skip, premask = None, mask
        full_len = x.shape[1]
        for i, blk in enumerate(self.block):
            if i == self.reduce_idx:
                skip = x
                x = self.time_reduce(x)
                if mask is not None:
                    mask = mask[:, ::2]
            if i == self.recover_idx and skip is not None:
                x = self.recover_proj(recover_resolution(x, full_len)) + skip
                mask = premask
            x = blk(x, mask, training, seed)
        return x


def _same_out(n: int) -> int:
    return -(-n // 2)


class Squeezeformer(nn.Module):
    """The CTC model: encoder, a biasless Linear, ``log_softmax`` in
    float32."""

    def __init__(self, num_classes: int = 60, dim: int = 144,
                 num_layers: int = 8, num_heads: int = 4, reduce_idx: int = 3,
                 recover_idx: int = 6, dropout: float = 0.1,
                 input_dim: int = 276, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = SpeechSqueezeformerEncoder(
            dim, num_layers, num_heads, reduce_idx=reduce_idx,
            recover_idx=recover_idx, dropout=dropout, input_dim=input_dim,
            dtype=dtype)
        self.fc = Dense(dim, num_classes, bias=False, dtype=dtype)

    def forward(self, x, mask=None, training: bool = False, seed=None):
        logits = self.fc(self.encoder(x, mask, training, seed))
        return torch.log_softmax(logits.to(torch.float32), dim=-1)
