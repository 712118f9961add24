"""CTC prefix beam search on the host (port of ``ishara_tpu/decode/beam.py``).

Standard log-space prefix beam search over (blank, non-blank) prefix
probabilities, in numpy, on log-probs copied once off the device. It is the
port's own copy of the reference's search, step for step: the candidate set
of ``np.argpartition`` over ``min(top_k_emissions, C - 1)``, prefixes merged
in insertion order and the stable ``sorted(...)[:beam_width]``, so it gives
the reference's beams on the same log-probs. The fixed-shape search that
runs inside the serving program is :mod:`ishara_tpu_torch.decode.beam_device`.
"""

from __future__ import annotations

import numpy as np

NEG_INF = -np.inf


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = max(a, b)
    return m + np.log(np.exp(a - m) + np.exp(b - m))


def ctc_beam_search(
    log_probs: np.ndarray,
    beam_width: int = 8,
    blank_id: int = 59,
    length: int | None = None,
    top_k_emissions: int = 16,
) -> list[tuple[tuple[int, ...], float]]:
    """[T, C] log-probs -> beams [(ids, log_prob)] sorted best-first.

    ``top_k_emissions`` prunes the per-frame expansion to the k most likely
    symbols (plus blank), which keeps the search O(T·beam·k).
    """
    T, C = log_probs.shape
    if length is not None:
        T = min(T, int(length))

    # prefix -> (p_blank, p_nonblank)
    beams: dict[tuple[int, ...], tuple[float, float]] = {(): (0.0, NEG_INF)}

    for t in range(T):
        lp = log_probs[t]
        cand = np.argpartition(-lp, min(top_k_emissions, C - 1))[:top_k_emissions]
        nxt: dict[tuple[int, ...], tuple[float, float]] = {}

        def acc(prefix, pb, pnb):
            opb, opnb = nxt.get(prefix, (NEG_INF, NEG_INF))
            nxt[prefix] = (_logaddexp(opb, pb), _logaddexp(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = _logaddexp(pb, pnb)
            # extend with blank
            acc(prefix, total + lp[blank_id], NEG_INF)
            # repeat last symbol (only the non-blank mass keeps the prefix)
            if prefix:
                acc(prefix, NEG_INF, pnb + lp[prefix[-1]])
            for c in cand:
                c = int(c)
                if c == blank_id:
                    continue
                if prefix and c == prefix[-1]:
                    # extending a repeat needs an intervening blank
                    acc(prefix + (c,), NEG_INF, pb + lp[c])
                else:
                    acc(prefix + (c,), NEG_INF, total + lp[c])

        scored = sorted(
            nxt.items(), key=lambda kv: -_logaddexp(*kv[1])
        )[:beam_width]
        beams = dict(scored)

    out = [
        (prefix, _logaddexp(pb, pnb)) for prefix, (pb, pnb) in beams.items()
    ]
    out.sort(key=lambda kv: -kv[1])
    return out


def beam_decode_batch(
    logits: np.ndarray,
    beam_width: int = 8,
    blank_id: int = 59,
    lengths: np.ndarray | None = None,
) -> list[list[int]]:
    """[B, T, C] logits -> best beam ids per sample."""
    logits = np.asarray(logits, np.float32)
    lse = np.log(np.sum(np.exp(logits - logits.max(-1, keepdims=True)), -1))
    log_probs = logits - logits.max(-1, keepdims=True) - lse[..., None]
    out = []
    for b in range(logits.shape[0]):
        n = None if lengths is None else int(lengths[b])
        beams = ctc_beam_search(log_probs[b], beam_width, blank_id, n)
        out.append(list(beams[0][0]) if beams else [])
    return out
