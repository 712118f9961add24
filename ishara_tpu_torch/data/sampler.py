"""Length-bucketed batch sampling: the port's own copy of
``ishara_tpu/data/sampler.py`` (numpy only; the same lengths, batch size,
boundaries, seed and epoch give the same batches in both packages).

Bucketing groups sequences into a small fixed set of raw-frame caps, so a
batch of short sequences is collated and computed at its own length. Off by
default (``TrainConfig.bucket_boundaries = ()``).
"""

from __future__ import annotations

import numpy as np


def dataset_lengths(dataset) -> np.ndarray:
    """Raw frame counts per sequence. Uses the dataset's O(1) metadata when
    available (``sequence_lengths()``), else renders once."""
    fn = getattr(dataset, "sequence_lengths", None)
    if fn is not None:
        return np.asarray(fn(), np.int64)
    return np.asarray([dataset.render(i)[0].shape[0]
                       for i in range(len(dataset))], np.int64)


class BucketSampler:
    """Yields (indices, frame_cap) batches with similar-length members.

    ``boundaries`` are the allowed static caps, ascending (e.g.
    (96, 192, 384)); a sequence belongs to the smallest cap >= its length
    (longer ones go to the last bucket and are truncated there, matching
    ``batch(..., max_frames=cap)`` semantics). Batches are whole-bucket,
    shuffled within and across buckets per epoch, deterministic in
    (seed, epoch)."""

    def __init__(self, lengths, batch_size: int,
                 boundaries: tuple[int, ...], seed: int = 0):
        if not boundaries or list(boundaries) != sorted(set(boundaries)):
            raise ValueError("boundaries must be ascending and non-empty")
        self.lengths = np.asarray(lengths, np.int64)
        self.batch_size = int(batch_size)
        self.boundaries = tuple(int(b) for b in boundaries)
        self.seed = int(seed)
        caps = np.full(len(self.lengths), self.boundaries[-1], np.int64)
        for b in reversed(self.boundaries):
            caps[self.lengths <= b] = b
        self._by_bucket = {b: np.flatnonzero(caps == b)
                           for b in self.boundaries}

    def batches(self, epoch: int) -> list[tuple[np.ndarray, int]]:
        rng = np.random.default_rng(self.seed * 1000 + epoch)
        out = []
        bs = self.batch_size
        carry = np.zeros((0,), np.int64)
        for b in self.boundaries:  # ascending: spilled members still fit
            idx = np.concatenate([carry, self._by_bucket[b]])
            perm = rng.permutation(idx)
            n = (len(perm) // bs) * bs
            for chunk in perm[:n].reshape(-1, bs):
                out.append((chunk, b))
            # sub-batch leftovers spill into the next (larger) cap instead
            # of being the same permanently-excluded sequences every epoch;
            # only the last bucket's remainder is dropped, and the per-epoch
            # permutation rotates which sequences that is
            carry = perm[n:]
        order = rng.permutation(len(out))
        return [out[i] for i in order]
