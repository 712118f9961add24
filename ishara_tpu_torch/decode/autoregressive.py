"""Autoregressive decoding for the encoder-decoder model (port of
``ishara_tpu/decode/autoregressive.py``).

* :func:`greedy_translate` -- re-applies the decoder over the whole prefix
  each step (O(S^2) work; the simple oracle).
* :func:`greedy_translate_cached` -- the serving path: cross-attention K/V
  once, per-layer self-attention K/V caches carried through the loop.
* :func:`beam_translate_cached` -- KV-cached beam search, one sequence.

PyTorch runs these loops eagerly, one step's launches after another. The
reference's ``while_loop`` tests ``all(finished)`` on the device; here that
test is a host sync, and it is made **once a step**: the loop is bound by
the host's launches (about sixty a step), so the device has finished all but
the last few kernels when the host asks, and a coarser test would spend
whole steps past the end. The tokens are the same whichever step the loop
stops at: a finished sequence only appends pad, which the buffer already
holds.
"""

from __future__ import annotations

import torch


def _init_tokens(B, max_len, sos, pad, device):
    tokens = torch.full((B, max_len), pad, dtype=torch.int32, device=device)
    tokens[:, 0] = sos
    return tokens


def _caches(model, B, max_len, like):
    H = model.num_heads
    Dh = model.feature_dim // H
    return [(like.new_zeros((B, max_len, H, Dh)),
             like.new_zeros((B, max_len, H, Dh)))
            for _ in range(model.num_decoder_layers)]


@torch.no_grad()
def greedy_translate(model, x, mask=None, max_len: int = 64, sos: int = 1,
                     eos: int = 2, pad: int = 0):
    """x [B, T, 92, 3] -> (token ids [B, max_len] int32 starting with sos,
    confidence [B]). Runs all ``max_len - 1`` steps, as the reference's
    ``fori_loop`` does."""
    memory, confidence = model.encode(x, mask)
    return greedy_from_memory(model, memory, mask, max_len, sos, eos,
                              pad), confidence


@torch.no_grad()
def greedy_from_memory(model, memory, mask=None, max_len: int = 64,
                       sos: int = 1, eos: int = 2, pad: int = 0):
    """:func:`greedy_translate`'s loop over an encoder output ``memory``
    [B, T, d]: token ids [B, max_len] int32."""
    B = memory.shape[0]
    tokens = _init_tokens(B, max_len, sos, pad, memory.device)
    finished = torch.zeros((B,), dtype=torch.bool, device=memory.device)
    for s in range(1, max_len):
        # positions >= s are not yet decoded; the causal mask hides them
        logits = model.decode(tokens, memory, mask)
        nxt = torch.argmax(logits[:, s - 1], dim=-1).to(torch.int32)
        nxt = torch.where(finished, pad, nxt)
        tokens[:, s] = nxt
        finished = finished | (nxt == eos)
    return tokens


@torch.no_grad()
def greedy_translate_cached(model, x, mask=None, max_len: int = 64,
                            sos: int = 1, eos: int = 2, pad: int = 0,
                            early_exit: bool = True):
    """KV-cached greedy decode; same contract as :func:`greedy_translate`.
    ``early_exit=False`` always runs all ``max_len - 1`` steps; the tokens
    are the same. Every sequence of the batch shares the loop, which stops
    at the slowest."""
    memory, confidence = model.encode(x, mask)
    cross = model.cross_kv(memory)
    B = x.shape[0]
    caches = _caches(model, B, max_len, memory)
    tokens = _init_tokens(B, max_len, sos, pad, x.device)
    finished = torch.zeros((B,), dtype=torch.bool, device=x.device)
    for s in range(1, max_len):
        if early_exit and bool(finished.all()):
            break
        logits, caches = model.decode_step(tokens[:, s - 1], s - 1, caches,
                                           cross, mask)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(finished, pad, nxt)
        tokens[:, s] = nxt
        finished = finished | (nxt == eos)
    return tokens, confidence


def length_normalised(tokens, scores, length_penalty: float, eos: int,
                      pad: int):
    """Divide each beam's raw log-probability by len^alpha, counting the
    generated tokens only: neither the sos at position 0, nor pad, nor
    eos."""
    if length_penalty <= 0.0:
        return scores
    gen = tokens[:, 1:]
    lengths = ((gen != pad) & (gen != eos)).sum(dim=1)
    return scores / torch.clamp(lengths, min=1).to(torch.float32) \
        ** length_penalty


def top_w(total: torch.Tensor, W: int):
    """Stable top-W of a [W, C] matrix flattened: descending values, and
    among equal values the smallest flat index first (``jax.lax.top_k``'s
    order). Returns (values [W], flat indices [W])."""
    flat = total.reshape(-1)
    order = torch.argsort(flat, descending=True, stable=True)[:W]
    return flat[order], order


@torch.no_grad()
def beam_translate_cached(model, x, mask=None, max_len: int = 64,
                          beam_width: int = 4, sos: int = 1, eos: int = 2,
                          pad: int = 0, length_penalty: float = 0.0):
    """KV-cached beam search over one sequence (x [1, T, 92, 3]). The beams
    ride the batch axis of :meth:`decode_step`; each step prunes the W*C
    continuations to the top W and reorders tokens and caches by parent.
    Only beam 0 is live at the first step (the others start at -inf), and
    a finished beam extends only with pad, at cost 0. ``length_penalty``
    alpha divides the final scores by len^alpha (0: the raw log-probability,
    where ``beam_width=1`` is greedy decoding). Returns (tokens [1,
    max_len] int32, confidence [1], score)."""
    if x.shape[0] != 1:
        raise ValueError("beam decode serves one sequence at a time")
    W, C = beam_width, model.num_classes
    memory, confidence = model.encode(x, mask)
    cross = [(k.expand(W, *k.shape[1:]), v.expand(W, *v.shape[1:]))
             for k, v in model.cross_kv(memory)]
    mask_w = None if mask is None else mask.expand(W, mask.shape[1])
    caches = _caches(model, W, max_len, memory)
    tokens = _init_tokens(W, max_len, sos, pad, x.device)
    scores = torch.full((W,), -torch.inf, device=x.device)
    scores[0] = 0.0
    finished = torch.zeros((W,), dtype=torch.bool, device=x.device)
    fin_row = torch.full((C,), -torch.inf, device=x.device)
    fin_row[pad] = 0.0
    for s in range(1, max_len):
        if bool(finished.all()):
            break
        logits, caches = model.decode_step(tokens[:, s - 1], s - 1, caches,
                                           cross, mask_w)
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = torch.where(finished[:, None], fin_row[None], logp)
        scores, idx = top_w(scores[:, None] + logp, W)
        parent, tok = idx // C, (idx % C).to(torch.int32)
        tokens = tokens[parent]
        tokens[:, s] = tok
        caches = [(k[parent], v[parent]) for k, v in caches]
        finished = finished[parent] | (tok == eos)
    scores = length_normalised(tokens, scores, length_penalty, eos, pad)
    best = torch.argmax(scores)
    return tokens[best][None], confidence, scores[best]
