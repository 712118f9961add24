"""Evaluation metrics: Levenshtein distance and the reference's three
normalized-score conventions (port of ``ishara_tpu/evaluation/metrics.py``):

* ``competition`` -- (len(target) - dist) / len(target), summed over the set:
  the ASLFR metric and the TFLite harness convention.
* ``max_len`` -- 1 - dist / max(len(pred), len(target)).
* ``pooled`` -- 1 - sum(dist) / sum(len(target)).

On the host. A corpus's distances come from the native batched library
(:mod:`ishara_tpu_torch.native`, C++ built at first use), as in the
reference, and from the two-row dynamic programme here when it cannot
build; the two give identical results.
"""

from __future__ import annotations

import numpy as np


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
    """The native batched library's distances when it is available
    (:mod:`ishara_tpu_torch.native`), else the Python DP's: identical."""
    from .. import native

    return [int(d) for d in native.batch_levenshtein(list(preds),
                                                     list(targets))]


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
        # numpy's pairwise mean, as the reference takes it (a running sum
        # differs in the last bits)
        return float(np.mean([1.0 - d / max(len(p), len(t), 1)
                              for d, p, t in zip(dists, preds, targets)]))
    if mode == "pooled":
        return 1.0 - sum(dists) / max(sum(len(t) for t in targets), 1)
    raise ValueError(mode)


def character_error_rate(preds: list[str], targets: list[str]) -> float:
    """CER = sum(dist) / sum(len(target))."""
    dists = _corpus_distances(preds, targets)
    return sum(dists) / max(sum(len(t) for t in targets), 1)
