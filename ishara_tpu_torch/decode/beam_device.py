"""CTC prefix beam search on the device (port of
``ishara_tpu/decode/beam_device.py``).

The fixed-shape form of the host search (:mod:`ishara_tpu_torch.decode.beam`)
that runs inside the serving program: beams are padded id buffers ``[W, U]``
with (blank, non-blank) log-mass, and each frame does

  expand (W beams x (K top symbols + blank + repeat) candidates)
  -> merge equal prefixes (pairwise-equality mask + masked logsumexp)
  -> top-W re-select,

all at fixed shapes, in torch ops on the log-probs' device. With K >= the
symbol count this is exact prefix search; a smaller K is the standard
emission-pruning approximation.

The frame loop reads nothing back to the host (no ``.item()``, no Python
branch on a tensor): frames past ``length`` are frozen by ``torch.where``, so
the loop can be traced (``torch.export``) or captured as a graph. The search
is also a registered operator (``torch.ops.ishara_tpu_torch.
ctc_prefix_beam_search``), which is what the serving program calls: a
program exported with ``torch.export`` then holds the search as one call of
this same loop rather than ~170 traced nodes a frame. Ties break
as ``jax.lax.top_k`` breaks them, to the lower index: a top-K or top-W is the
head of a stable descending sort. Every mass is float32 and a dead mass is
``NEG = -1e30``, whose sums stay at or below ``NEG`` as in the reference.
"""

from __future__ import annotations

import torch

from ..data.landmarks import MAX_PHRASE_LENGTH
from ..data.vocab import PAD_TOKEN_IDX

NEG = -1e30


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    both = m <= NEG
    m_safe = torch.where(both, 0.0, m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    return torch.where(both, NEG,
                       m_safe + torch.log(torch.where(both, 1.0, s)))


def _merge_logsumexp(scores, eq):
    """scores [N], eq [N, N] boolean equality -> per-group logsumexp placed
    at every member (groups read their total)."""
    s = torch.where(eq, scores[None, :], NEG)  # [N, N] row i: members of i
    m = torch.amax(s, dim=1, keepdim=True)
    m_safe = torch.where(m <= NEG, 0.0, m)
    out = m_safe[:, 0] + torch.log(torch.sum(torch.exp(s - m_safe), dim=1))
    return torch.where(m[:, 0] <= NEG, NEG, out)


def _top(x, k: int):
    """Indices of the k largest entries of x [N], ties to the lower index
    (``jax.lax.top_k``'s order)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def search(log_probs: torch.Tensor, length: torch.Tensor, beam_width: int,
           top_k: int, max_len: int, blank_id: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The frame loop of :func:`beam_search_device` in torch ops (what its
    registered operator runs); ``length`` a 0-d tensor on the log-probs'
    device."""
    T, C = log_probs.shape
    W, K, U = beam_width, top_k, max_len
    NCAND = W * (K + 2)
    dev = log_probs.device
    lp_all = log_probs.to(torch.float32)

    ids = torch.full((W, U), blank_id, dtype=torch.int32, device=dev)
    lens = torch.zeros((W,), dtype=torch.int32, device=dev)
    pb = torch.full((W,), NEG, dtype=torch.float32, device=dev)
    pb[0] = 0.0                         # only beam 0 alive initially
    pnb = torch.full((W,), NEG, dtype=torch.float32, device=dev)
    cols = torch.arange(U, device=dev)
    first_of = torch.arange(NCAND, device=dev)
    neg_k = torch.full((W, K), NEG, dtype=torch.float32, device=dev)
    neg_1 = torch.full((W, 1), NEG, dtype=torch.float32, device=dev)
    # every frame's top K symbols (may include blank) at once
    top_all = torch.sort(lp_all, dim=1, descending=True,
                         stable=True).indices[:, :K]
    val_all = torch.gather(lp_all, 1, top_all)
    sym_all = top_all.to(torch.int32)
    blank_all = lp_all[:, blank_id]

    for t in range(T):
        lp = lp_all[t]
        active = length > t
        top_val, sym = val_all[t], sym_all[t]
        total = _logaddexp(pb, pnb)                     # [W]
        prev = torch.gather(ids, 1,
                            torch.clamp(lens - 1, min=0).long()[:, None])
        last = torch.where(lens > 0, prev[:, 0], -1)

        # --- candidates: per beam [K extensions] + [blank] + [repeat] ----
        is_rep = sym[None, :] == last[:, None]                      # [W, K]
        ext_mass = torch.where(is_rep, pb[:, None], total[:, None]) \
            + top_val[None, :]
        ext_mass = torch.where((sym == blank_id)[None, :]
                               | (lens >= U)[:, None], NEG, ext_mass)
        at = cols[None, :] == torch.clamp(lens, max=U - 1)[:, None]  # [W, U]
        ext_ids = torch.where(at[:, None, :], sym[None, :, None],
                              ids[:, None, :])                    # [W, K, U]
        ext_len = torch.where(ext_mass <= NEG, lens[:, None],
                              torch.clamp(lens + 1, max=U)[:, None])
        rep_lp = torch.where(last >= 0, lp[torch.clamp(last, min=0).long()],
                             NEG)

        c_ids = torch.cat([ext_ids, ids[:, None, :], ids[:, None, :]],
                          1).reshape(NCAND, U)
        c_len = torch.cat([ext_len, lens[:, None], lens[:, None]],
                          1).reshape(NCAND)
        c_pb = torch.cat([neg_k, (total + blank_all[t])[:, None], neg_1],
                         1).reshape(NCAND)
        c_pnb = torch.cat([ext_mass, neg_1, (pnb + rep_lp)[:, None]],
                          1).reshape(NCAND)

        alive = _logaddexp(c_pb, c_pnb) > NEG

        # --- merge identical prefixes ------------------------------------
        eq = ((c_len[:, None] == c_len[None, :])
              & torch.all(c_ids[:, None, :] == c_ids[None, :, :], dim=-1)
              & alive[:, None] & alive[None, :])
        m_pb = _merge_logsumexp(c_pb, eq)
        m_pnb = _merge_logsumexp(c_pnb, eq)
        # keep only the first member of each group, and kill the mass on
        # the duplicates: a re-admitted copy (when fewer than W prefixes
        # are alive) would carry the merged mass again on every frame
        keep = (torch.argmax(eq.to(torch.uint8), dim=1) == first_of) & alive
        m_pb = torch.where(keep, m_pb, NEG)
        m_pnb = torch.where(keep, m_pnb, NEG)
        score = torch.where(keep, _logaddexp(m_pb, m_pnb), NEG)

        # --- top-W re-select, frozen past the sequence length ------------
        sel = _top(score, W)
        ids = torch.where(active, c_ids[sel], ids)
        lens = torch.where(active, c_len[sel], lens)
        pb = torch.where(active, m_pb[sel], pb)
        pnb = torch.where(active, m_pnb[sel], pnb)

    final = _logaddexp(pb, pnb)
    best = torch.argmax(final)
    return ids[best].to(torch.long), lens[best].to(torch.long), final[best]


@torch.library.custom_op("ishara_tpu_torch::ctc_prefix_beam_search",
                         mutates_args=())
def _search_op(log_probs: torch.Tensor, length: torch.Tensor,
               beam_width: int, top_k: int, max_len: int, blank_id: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return search(log_probs, length, beam_width, top_k, max_len, blank_id)


@_search_op.register_fake
def _(log_probs, length, beam_width, top_k, max_len, blank_id):
    return (log_probs.new_empty((max_len,), dtype=torch.long),
            log_probs.new_empty((), dtype=torch.long),
            log_probs.new_empty((), dtype=torch.float32))


def beam_search_device(
    log_probs: torch.Tensor,
    length: torch.Tensor | None = None,
    beam_width: int = 8,
    top_k: int = 8,
    max_len: int = MAX_PHRASE_LENGTH,
    blank_id: int = PAD_TOKEN_IDX,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[T, C] log-probs -> (ids [max_len] of the best beam, padded with
    blank, its count, its log-prob), on the log-probs' device. ``length``
    (a 0-d tensor or int) freezes the beams after that many frames; None
    searches all T frames."""
    T, C = log_probs.shape
    if not 1 <= top_k <= C:
        raise ValueError(f"top_k must be in [1, {C}], got {top_k}")
    dev = log_probs.device
    if length is None:
        length = torch.full((), T, dtype=torch.int32, device=dev)
    length = torch.as_tensor(length, device=dev).reshape(())
    return _search_op(log_probs, length, beam_width, top_k, max_len,
                      blank_id)


def beam_decode_device_batch(logits: torch.Tensor,
                             lengths: torch.Tensor | None = None, **kw
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, C] logits -> (ids [B, max_len], counts [B]): the log-softmax
    in float32, then :func:`beam_search_device` on each row (``kw`` as its
    keyword arguments)."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    rows = [beam_search_device(lp[b], None if lengths is None
                               else lengths[b], **kw)[:2]
            for b in range(lp.shape[0])]
    return (torch.stack([i for i, _ in rows]),
            torch.stack([c for _, c in rows]))
