"""End-to-end evaluation harness (port of
``ishara_tpu/evaluation/harness.py``): iterate held-out sequences through a
serving engine, score the three normalized Levenshtein conventions, and
measure per-sequence latency on the host clock (each call ends with the ids
copied back, so it includes the device's work).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .metrics import normalized_levenshtein


@dataclass
class HarnessResult:
    num_sequences: int
    score: float                 # competition normalization (cell 18)
    score_maxlen: float
    score_pooled: float
    latency_ms_p50: float
    latency_ms_p99: float
    examples: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "num_sequences": self.num_sequences,
            "score": self.score,
            "score_maxlen": self.score_maxlen,
            "score_pooled": self.score_pooled,
            "latency_ms_p50": self.latency_ms_p50,
            "latency_ms_p99": self.latency_ms_p99,
        }


def dominant_hand_filter(dataset, indices, y_mul: float = 1.0):
    """Reference harness filter (cell 15): keep sequences whose dominant-hand
    non-NaN frame count exceeds y_mul * len(phrase)."""
    from ..data import landmarks as lm

    kept = []
    for i in indices:
        x, phrase = dataset.render(int(i))
        rh = x[:, lm.GROUP_IDX["rhand"][:, 0]]
        lh = x[:, lm.GROUP_IDX["lhand"][:, 0]]
        frames = max(
            np.sum(~np.isnan(rh).all(axis=1)),
            np.sum(~np.isnan(lh).all(axis=1)),
        )
        if frames > y_mul * max(len(phrase), 1):
            kept.append(int(i))
    return kept


def run_harness(
    engine,
    dataset,
    tokenizer,
    num_sequences: int = 1000,
    apply_filter: bool = False,
    warmup: int = 3,
    translation: bool = False,
) -> HarnessResult:
    """Evaluate a serving engine over up to ``num_sequences``.

    ``translation=False``: CTC InferenceEngine (returns (ids, count)).
    ``translation=True``: TranslationEngine (returns (ids, confidence); the
    Seq2SeqTokenizer stops decoding at eos itself)."""
    indices = list(range(min(num_sequences, len(dataset))))
    if apply_filter:
        indices = dominant_hand_filter(dataset, indices)

    for i in indices[:warmup]:
        engine(dataset.render(i)[0])

    preds, targets, lat = [], [], []
    for i in indices:
        x, phrase = dataset.render(i)
        t0 = time.perf_counter()
        out = engine(x)
        lat.append((time.perf_counter() - t0) * 1e3)
        if translation:
            ids, _conf = out
            preds.append(tokenizer.decode(ids))
        else:
            ids, count = out
            preds.append(tokenizer.decode(ids[:count]))
        targets.append(phrase)

    return HarnessResult(
        num_sequences=len(indices),
        score=normalized_levenshtein(preds, targets),
        score_maxlen=normalized_levenshtein(preds, targets, "max_len"),
        score_pooled=normalized_levenshtein(preds, targets, "pooled"),
        latency_ms_p50=float(np.percentile(lat, 50)) if lat else float("nan"),
        latency_ms_p99=float(np.percentile(lat, 99)) if lat else float("nan"),
        examples=list(zip(preds[:10], targets[:10])),
    )
