"""Evaluation metrics: Levenshtein distance and the reference's three
normalized-score conventions (port of ``ishara_tpu/evaluation/metrics.py``):

* ``competition`` -- (len(target) - dist) / len(target), summed over the set:
  the ASLFR metric and the TFLite harness convention.
* ``max_len`` -- 1 - dist / max(len(pred), len(target)).
* ``pooled`` -- 1 - sum(dist) / sum(len(target)).

Pure Python on the host. The reference's native batched distance is not
ported yet (ROADMAP.md Queue 1: the rest); the two-row dynamic programme here
gives identical results.
"""

from __future__ import annotations


def levenshtein(a: str, b: str) -> int:
    """Classic O(len(a) * len(b)) edit distance, two-row DP."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def _corpus_distances(preds, targets) -> list[int]:
    return [levenshtein(p, t) for p, t in zip(preds, targets)]


def normalized_levenshtein(preds: list[str], targets: list[str],
                           mode: str = "competition") -> float:
    """Aggregate normalized Levenshtein score over a corpus."""
    if len(preds) != len(targets):
        raise ValueError("preds and targets must align")
    dists = _corpus_distances(preds, targets)
    if mode == "competition":
        num = sum(max(len(t), 1) - d for d, t in zip(dists, targets))
        den = sum(max(len(t), 1) for t in targets)
        return num / den
    if mode == "max_len":
        scores = [1.0 - d / max(len(p), len(t), 1)
                  for d, p, t in zip(dists, preds, targets)]
        return float(sum(scores) / len(scores))
    if mode == "pooled":
        return 1.0 - sum(dists) / max(sum(len(t) for t in targets), 1)
    raise ValueError(mode)


def character_error_rate(preds: list[str], targets: list[str]) -> float:
    """CER = sum(dist) / sum(len(target))."""
    dists = _corpus_distances(preds, targets)
    return sum(dists) / max(sum(len(t) for t in targets), 1)
