"""ASLFR parquet dataset: loading, signer-fold splits, statistics (port of
``ishara_tpu/data/dataset.py``; numpy, with pandas and pyarrow imported
only when a corpus is opened).

* lazy per-file parquet reads with an LRU table cache, or the whole corpus
  preloaded into RAM;
* signer-based k-fold splits on ``participant_id``;
* landmark selection to the 276 ``SEL_COLS`` (a missing column is NaN);
* ``process_index`` / ``process_count``: each process of a data-parallel
  run reads a disjoint slice of the corpus
  (:func:`ishara_tpu_torch.parallel.process_shard`);
* per-group mean / std over the corpus (:func:`compute_group_stats`).

It serves the ``render`` / ``batch`` protocol of
:class:`ishara_tpu_torch.data.synthetic.SyntheticASLFR`, so the ``Trainer``
and the evaluation harness do not care where sequences come from.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

from . import landmarks as lm
from .vocab import PAD_TOKEN_IDX


class ParquetASLFR:
    def __init__(
        self,
        data_dir: str | Path,
        csv_name: str = "train.csv",
        landmarks_dir: str = "train_landmarks",
        fold: int | None = None,
        num_folds: int = 4,
        split: str = "train",
        preload: bool = False,
        max_sequences: int | None = None,
        cache_files: int = 4,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        """``process_index`` / ``process_count`` shard the corpus across
        processes: process ``i`` of ``n`` reads every ``n``-th row of the
        csv from row ``i``, before the fold split, which is a function of
        the participant id alone."""
        import pandas as pd

        self.data_dir = Path(data_dir)
        self.landmarks_dir = self.data_dir / landmarks_dir
        df = pd.read_csv(self.data_dir / csv_name)

        if process_count is not None and process_count > 1:
            df = df.iloc[(process_index or 0)::process_count]

        if fold is not None:
            in_fold = df["participant_id"].map(
                lambda s: int(s) % num_folds) == fold
            df = df[~in_fold] if split == "train" else df[in_fold]

        if max_sequences is not None:
            df = df.iloc[:max_sequences]
        self.df = df.reset_index(drop=True)

        self._read_file = lru_cache(maxsize=cache_files)(self._read_file_raw)
        self._ram: dict[int, np.ndarray] | None = None
        if preload:
            self._ram = {i: self._load_seq(i) for i in range(len(self.df))}

    def __len__(self) -> int:
        return len(self.df)

    def _read_file_raw(self, file_id):
        import pyarrow.parquet as pq

        return pq.read_table(self.landmarks_dir
                             / f"{file_id}.parquet").to_pandas()

    def _load_seq(self, idx: int) -> np.ndarray:
        row = self.df.iloc[idx]
        frames = self._read_file(row["file_id"])
        seq = frames.loc[frames.index == row["sequence_id"]] \
            if frames.index.name == "sequence_id" \
            else frames[frames["sequence_id"] == row["sequence_id"]]
        out = np.full((len(seq), lm.N_COLS), np.nan, np.float32)
        for c, col in enumerate(lm.SEL_COLS):
            if col in seq.columns:
                out[:, c] = seq[col].to_numpy(np.float32)
        return out

    def render(self, idx: int) -> tuple[np.ndarray, str]:
        x = self._ram[idx] if self._ram is not None else self._load_seq(idx)
        return x, str(self.df.iloc[idx]["phrase"])

    def batch(self, indices, tokenizer, max_frames: int = 384,
              max_phrase: int = lm.MAX_PHRASE_LENGTH) -> dict:
        return collate(self, indices, tokenizer, max_frames, max_phrase)


def collate(dataset, indices, tokenizer, max_frames: int = 384,
            max_phrase: int = lm.MAX_PHRASE_LENGTH) -> dict:
    """The ``batch`` of the render protocol: ``raw`` ``[B, max_frames,
    276]`` (zero past each sequence's end, which is cut at
    ``max_frames``), ``lengths`` (at least 1), ``labels`` (tokenized,
    padded) and the ``phrases``."""
    indices = list(indices)
    xs = np.zeros((len(indices), max_frames, lm.N_COLS), np.float32)
    lens = np.zeros((len(indices),), np.int32)
    labels = np.full((len(indices), max_phrase), PAD_TOKEN_IDX, np.int32)
    phrases = []
    for i, idx in enumerate(indices):
        x, phrase = dataset.render(int(idx))
        T = min(x.shape[0], max_frames)
        xs[i, :T] = x[:T]
        lens[i] = max(T, 1)
        labels[i] = tokenizer.encode(phrase, max_len=max_phrase)
        phrases.append(phrase)
    return {"raw": xs, "lengths": lens, "labels": labels, "phrases": phrases}


def compute_group_stats(dataset, num_sequences: int | None = None):
    """Per-group, per-coordinate mean and std over the corpus (NaN-aware,
    float64 sums), each ``[1, 1, 3]`` float32, as the port's
    :class:`~ishara_tpu_torch.preprocess.pipeline.GroupStats`: the rebuild
    of the reference's precomputed mean / std side dataset."""
    import torch

    from ..preprocess.pipeline import GroupStats

    n = len(dataset) if num_sequences is None else min(
        num_sequences, len(dataset))
    sums = {g: np.zeros(3, np.float64) for g in lm.GROUPS}
    sqs = {g: np.zeros(3, np.float64) for g in lm.GROUPS}
    counts = {g: np.zeros(3, np.float64) for g in lm.GROUPS}
    for i in range(n):
        x, _ = dataset.render(i)
        for g in lm.GROUPS:
            grp = np.stack(
                [x[:, lm.GROUP_IDX[g][:, c]] for c in range(3)], axis=-1)
            valid = ~np.isnan(grp)
            grp0 = np.where(valid, grp, 0.0)
            sums[g] += grp0.sum((0, 1))
            sqs[g] += (grp0 ** 2).sum((0, 1))
            counts[g] += valid.sum((0, 1))
    mean, std = {}, {}
    for g in lm.GROUPS:
        c = np.maximum(counts[g], 1.0)
        m = sums[g] / c
        v = np.maximum(sqs[g] / c - m ** 2, 1e-8)
        mean[g] = torch.from_numpy(m.astype(np.float32).reshape(1, 1, 3))
        std[g] = torch.from_numpy(np.sqrt(v).astype(np.float32)
                                  .reshape(1, 1, 3))
    return GroupStats(mean=mean, std=std)


def normalize_per_sequence(x: np.ndarray) -> np.ndarray:
    """Per-sequence standardization, then NaN -> 0."""
    m = np.nanmean(x, axis=0, keepdims=True)
    s = np.nanstd(x, axis=0, keepdims=True)
    out = (x - m) / np.where(s < 1e-6, 1.0, s)
    return np.nan_to_num(out, nan=0.0)
