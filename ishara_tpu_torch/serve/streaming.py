"""Chunked streaming of a causal encoder (port of
``ishara_tpu/serve/streaming.py``).

A ``cfg.causal=True`` encoder of an attention-block family (causal
attention within ``attn_context`` keys, causal convs, the running-mean SE
gate) streams: each block carries a small state, and each frame is
processed once.

Per-block state (:class:`BlockState`, tensors on the device):

* attention -- rolling K / V caches of the last ``attn_context`` projected
  keys and values ``[W, dim]`` (a frame's K / V never change in a causal
  model, so caching the projections is exact);
* conv -- the last ``k-1`` rows of the depthwise conv's input;
* SE gate -- the running sum ``[dim]`` and count of the valid frames of the
  conv module's output (the streaming form of ``causal_masked_mean``).

:class:`StreamState` adds the global frame position (a host integer: it
indexes the positional-encoding table and grows by the chunk size each
step), the last argmax id, and the validity of the cached key frames.

:meth:`StreamingEncoder.step` takes a chunk of raw landmark frames,
normalises them with the training statistics (no resampling: a live stream
has no known length, the one deliberate difference from the batch path),
runs the blocks, and collapses greedy CTC ids across the chunk boundary.
A chunk is tensor operations on the device with no read back to the host.
Its logits equal the batch causal forward's at the same frames (float32,
whatever ``cfg.dtype``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BN_EPS, LN_EPS, LN_EPS_DEFAULT, EncoderConfig
from ..data.vocab import ASLFR_CHARS
from ..device import resolve_device
from ..models.encoder import ATTENTION_VARIANTS
from ..models.layers import positional_encoding
from ..preprocess.pipeline import GroupStats, _cols, _flat_stats


class BlockState(NamedTuple):
    k_cache: torch.Tensor      # [W, dim]
    v_cache: torch.Tensor      # [W, dim]
    conv_tail: torch.Tensor    # [k-1, conv width]
    se_sum: torch.Tensor       # [dim] ([0] for Conformer blocks)
    se_count: torch.Tensor     # 0-d f32


class StreamState(NamedTuple):
    pos: int                   # global index of the chunk's first frame
    blocks: tuple              # a BlockState per block
    prev_id: torch.Tensor      # 0-d int64: the last frame's argmax id
    # validity of the cached key frames [W] (Keras Masking(0.0): a frame
    # with any nonzero feature), one vector for the whole stack
    valid_cache: torch.Tensor


def _ln(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], eps)


def _dense(x, p):
    y = x @ p["weight"]
    return y + p["bias"] if "bias" in p else y


def _ffn(x, p):
    return _dense(F.silu(_dense(x, p["fc1"])), p["fc2"])


def _allowed(pos, C, W, valid_all):
    """[C, W+C]: which keys (the W cached frames, then the chunk's) each of
    the chunk's queries may attend to. Cache row j holds global frame
    ``pos - W + j`` (none while that is negative); a query attends
    causally within the last W frames to the valid keys, as the batch
    causal mask does."""
    dev = valid_all.device
    gq = pos + torch.arange(C, device=dev)[:, None]
    gk = pos - W + torch.arange(W + C, device=dev)[None, :]
    return (gk <= gq) & (gk >= 0) & (gq - gk < W) \
        & (valid_all[None, :] > 0.5)


def _mhsa_step(h, p, st: BlockState, num_heads, dim, allowed):
    """h [C, dim] (normed) -> ([C, dim], new K / V caches)."""
    C = h.shape[0]
    W = st.k_cache.shape[0]
    dh = dim // num_heads
    qkv = (h @ p["qkv"]["weight"]).reshape(C, num_heads, 3 * dh)
    q = qkv[..., :dh]
    k_all = torch.cat([st.k_cache, qkv[..., dh:2 * dh].reshape(C, dim)])
    v_all = torch.cat([st.v_cache, qkv[..., 2 * dh:].reshape(C, dim)])
    kh = k_all.reshape(W + C, num_heads, dh)
    vh = v_all.reshape(W + C, num_heads, dh)
    s = torch.einsum("qhd,khd->hqk", q, kh) * dim ** -0.5
    s = s.masked_fill(~allowed[None], torch.finfo(s.dtype).min)
    o = torch.einsum("hqk,khd->qhd", s.softmax(dim=-1), vh).reshape(C, dim)
    return o @ p["proj"]["weight"], k_all[C:], v_all[C:]


def _causal_dw_step(h, w, tail):
    """Depthwise causal conv of a chunk with its carried left context:
    h [C, E], w [E, 1, k], tail [k-1, E] -> ([C, E], the new tail)."""
    C = h.shape[0]
    full = torch.cat([tail, h])                               # [k-1+C, E]
    out = F.conv1d(full.t()[None], w, groups=w.shape[0])[0].t()
    return out, full[C:]


def _squeeze_block_step(x, p, st: BlockState, num_heads, dim, allowed,
                        valid):
    """A SqueezeformerBlock in eval: FFN1 -> MHSA -> conv module with the
    running-mean SE gate (only valid frames feed it) -> FFN2."""
    x = x + _ffn(_ln(x, p["norm1"], LN_EPS), p["ffn1"])
    att, k_c, v_c = _mhsa_step(_ln(x, p["norm2"], LN_EPS), p["mha"], st,
                               num_heads, dim, allowed)
    x = x + att
    c = p["conv"]
    h = F.silu(_dense(_ln(x, c["norm"], LN_EPS), c["pw1"]))
    h, tail = _causal_dw_step(h, c["dw"]["dwconv"]["weight"], st.conv_tail)
    h = _dense(F.silu(h), c["pw2"])
    cum = st.se_sum[None, :] + torch.cumsum(h * valid[:, None], dim=0)
    cnt = st.se_count + torch.cumsum(valid, dim=0)[:, None]
    g = cum / torch.clamp(cnt, min=1.0)
    g = torch.sigmoid(_dense(F.silu(_dense(g, c["se"]["fc1"])),
                             c["se"]["fc2"]))
    x = x + h * g
    x = x + _ffn(_ln(x, p["norm3"], LN_EPS), p["ffn2"])
    return x, BlockState(k_c, v_c, tail, cum[-1], st.se_count + valid.sum())


def _conformer_block_step(x, p, st: BlockState, num_heads, dim, allowed):
    """A ConformerBlock in eval: shared-ln1 FFN1 / MHSA, the causal GLU
    conv with BN running statistics, the post-LN residual, FFN2."""
    x = x + _ffn(_ln(x, p["ln1"], LN_EPS), p["ffn1"])
    att, k_c, v_c = _mhsa_step(_ln(x, p["ln1"], LN_EPS), p["mha"], st,
                               num_heads, dim, allowed)
    x = x + att
    c = p["conv"]
    a, b = _dense(x, c["pw1"]).split(dim, dim=-1)
    h, tail = _causal_dw_step(a * torch.sigmoid(b), c["dw"]["weight"],
                              st.conv_tail)
    bn = c["bn"]
    h = (h + c["dw"]["bias"] - bn["running_mean"]) \
        * torch.rsqrt(bn["running_var"] + BN_EPS) * bn["weight"] + bn["bias"]
    x = _ln(_dense(h, c["pw2"]) + x, c["ln"], LN_EPS_DEFAULT)
    x = x + _ffn(_ln(x, p["ln2"], LN_EPS), p["ffn2"])
    return x, BlockState(k_c, v_c, tail, st.se_sum, st.se_count)


def _weights(state_dict, device) -> dict:
    """The ``state_dict`` as a nested dict of f32 tensors on ``device``:
    Linear and 1x1 Conv weights as ``[in, out]``, depthwise ones as they
    are (``[C, 1, k]``)."""
    tree: dict = {}
    for key, v in state_dict.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        v = v.detach().to(device=device, dtype=torch.float32)
        if leaf == "weight" and v.dim() == 3 and v.shape[1] != 1:
            v = v[:, :, 0]                                   # 1x1 conv
        if leaf == "weight" and v.dim() == 2:
            v = v.t()
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.contiguous()
    return tree


class StreamingEncoder:
    """Chunked real-time inference over a ``cfg.causal=True`` encoder of an
    attention-block family, on ``device`` (default ``cuda``; raises when no
    card is visible). ``weights`` is the port's model or its
    ``state_dict``.

    >>> eng = StreamingEncoder(cfg, model, stats, chunk_size=8)
    >>> state = eng.init_state()
    >>> emitted = []
    >>> for chunk in frames.reshape(-1, 8, 276):
    ...     state, ids, n, logits = eng.step(state, chunk)
    ...     emitted.append(ids)
    >>> text = eng.decode_text(StreamingEncoder.collect(emitted))
    """

    def __init__(self, cfg: EncoderConfig, weights,
                 stats: GroupStats | None = None, chunk_size: int = 8,
                 max_positions: int = 2048, device=None):
        if not cfg.causal:
            raise ValueError("StreamingEncoder requires cfg.causal=True")
        if cfg.variant not in ATTENTION_VARIANTS:
            raise ValueError(f"streaming unsupported for {cfg.variant!r}")
        if cfg.attn_context <= 0:
            raise ValueError("streaming needs a bounded attn_context (> 0)")
        if cfg.dominant_hand:
            # the mirror decision picks the hand with fewer NaNs over the
            # whole sequence, which a live stream does not have
            raise ValueError(
                "cfg.dominant_hand models cannot stream: the mirror "
                "decision needs the full sequence; train the streaming "
                "model with dominant_hand=False (lr_flip augmentation "
                "instead)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.chunk_size = int(chunk_size)
        self.max_positions = int(max_positions)
        sd = weights.state_dict() if isinstance(weights, torch.nn.Module) \
            else weights
        self.params = _weights(sd, self.device)
        self._mean, self._std = _flat_stats(stats or GroupStats.identity(),
                                            self.device)
        self._cols = _cols("out", self.device)
        self._pe = torch.as_tensor(
            positional_encoding(self.max_positions, cfg.dim),
            device=self.device)
        self._n_squeeze = cfg.num_squeeze_blocks \
            if cfg.variant in ("squeezeformer", "hybrid") else 0
        self._n_conform = cfg.num_conform_blocks \
            if cfg.variant in ("conformer", "hybrid") else 0

    def init_state(self) -> StreamState:
        cfg, dev = self.cfg, self.device
        W, k = cfg.attn_context, cfg.transformer_kernel_size

        def blk(conv_width, se):
            z = torch.zeros
            return BlockState(
                z((W, cfg.dim), device=dev), z((W, cfg.dim), device=dev),
                z((k - 1, conv_width), device=dev),
                z((cfg.dim if se else 0,), device=dev), z((), device=dev))

        blocks = tuple(blk(cfg.dim * cfg.expansion_factor, True)
                       for _ in range(self._n_squeeze))
        blocks += tuple(blk(cfg.dim, False) for _ in range(self._n_conform))
        return StreamState(
            pos=0, blocks=blocks,
            prev_id=torch.tensor(cfg.blank_id, device=dev),
            valid_cache=torch.zeros((W,), device=dev))

    @torch.no_grad()
    def _step(self, state: StreamState, chunk):
        cfg, p = self.cfg, self.params
        C = chunk.shape[0]
        x = torch.nan_to_num((chunk[:, self._cols] - self._mean) / self._std,
                             nan=0.0)
        # Masking(0.0), as the batch path's frame_mask: an all-zero frame is
        # no attention key and does not feed the SE running mean
        valid = (x != 0.0).any(dim=-1).to(torch.float32)          # [C]
        valid_all = torch.cat([state.valid_cache, valid])         # [W+C]
        x = x @ p["stem_conv"]["weight"] + self._pe[state.pos:state.pos + C]
        bn = p["stem_bn"]
        x = (x - bn["running_mean"]) \
            * torch.rsqrt(bn["running_var"] + BN_EPS) * bn["weight"] \
            + bn["bias"]
        args = (cfg.num_heads, cfg.dim,
                _allowed(state.pos, C, cfg.attn_context, valid_all))
        blocks = []
        for i in range(self._n_squeeze):
            x, st = _squeeze_block_step(x, p["squeezeformer"][str(i)],
                                        state.blocks[i], *args, valid)
            blocks.append(st)
        for i in range(self._n_conform):
            x, st = _conformer_block_step(
                x, p["conformer"][str(i)],
                state.blocks[self._n_squeeze + i], *args)
            blocks.append(st)
        x = torch.relu(_dense(x, p["top_conv"]))
        logits = _dense(x, p["classifier"])
        # greedy CTC collapse across the chunk boundary
        ids = logits.argmax(dim=-1)
        prev = torch.cat([state.prev_id[None], ids[:-1]])
        emit = (ids != prev) & (ids != cfg.blank_id)
        new_state = StreamState(pos=state.pos + C, blocks=tuple(blocks),
                                prev_id=ids[-1], valid_cache=valid_all[C:])
        return new_state, torch.where(emit, ids, -1), emit.sum(), logits

    def step(self, state: StreamState, chunk):
        """Feed one ``[chunk_size, 276]`` block of raw frames. Returns
        (new state, emitted ids [C] with -1 at non-emitting frames, the
        number emitted, logits [C, num_classes]), all on the device."""
        chunk = torch.as_tensor(chunk, dtype=torch.float32).to(self.device)
        if tuple(chunk.shape) != (self.chunk_size, self.cfg.input_dim):
            raise ValueError(f"chunk must be [{self.chunk_size}, "
                             f"{self.cfg.input_dim}], got "
                             f"{tuple(chunk.shape)}")
        if state.pos + self.chunk_size > self.max_positions:
            # the PE table would run out and repeat its last rows
            raise ValueError(
                f"stream exceeds max_positions={self.max_positions}; "
                f"construct StreamingEncoder with a larger max_positions "
                f"or restart the state")
        return self._step(state, chunk)

    @staticmethod
    def collect(emitted_ids) -> list[int]:
        """Host-side: the ids of the emitting frames of ``step`` outputs."""
        out = []
        for ids in emitted_ids:
            out.extend(int(i) for i in np.asarray(torch.as_tensor(ids).cpu())
                       if i >= 0)
        return out

    def decode_text(self, ids) -> str:
        return "".join(ASLFR_CHARS[i] for i in ids
                       if 0 <= i < len(ASLFR_CHARS))
