"""Shard cache of a corpus (port of ``ishara_tpu/data/cache.py``; numpy
only).

Raw ``[T, 276]`` sequences and their phrases are packed once into
compressed ``.npz`` shards with a ``manifest.json``, and
:class:`ShardedASLFR` serves the ``render`` / ``batch`` protocol from them,
so training reads decoded arrays instead of parsing parquet again. The
format is the JAX package's: a directory written by either package reads
the same in the other.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

import numpy as np

from . import landmarks as lm
from .dataset import collate


def write_shards(dataset, out_dir: str | Path, shard_size: int = 512,
                 num_workers: int = 1) -> Path:
    """Pack any render-protocol dataset into ``.npz`` shards and a
    manifest. ``num_workers > 1`` writes shards on a thread pool (parquet
    reads and zlib release the GIL); the grouping of sequences into shards
    is fixed and sequential, so the output is byte-identical for any worker
    count."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = len(dataset)
    groups = [(s, list(range(s * shard_size, min((s + 1) * shard_size, n))))
              for s in range((n + shard_size - 1) // shard_size)]

    def build(arg):
        shard_idx, idxs = arg
        xs, lens, phrases = [], [], []
        for i in idxs:
            x, phrase = dataset.render(i)
            xs.append(x.astype(np.float32))
            lens.append(x.shape[0])
            phrases.append(phrase)
        Tmax = max(x.shape[0] for x in xs)
        arr = np.full((len(xs), Tmax, lm.N_COLS), np.nan, np.float32)
        for i, x in enumerate(xs):
            arr[i, : x.shape[0]] = x
        path = out_dir / f"shard_{shard_idx:05d}.npz"
        np.savez_compressed(path, x=arr, lengths=np.asarray(lens, np.int32),
                            phrases=np.asarray(phrases, object))
        return {"file": path.name, "count": len(xs)}

    if num_workers > 1 and len(groups) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            manifest = list(pool.map(build, groups))
    else:
        manifest = [build(g) for g in groups]
    (out_dir / "manifest.json").write_text(json.dumps(manifest))
    return out_dir


class ShardedASLFR:
    """The render / batch protocol from a shard directory; at most three
    shards are held in memory at a time."""

    def __init__(self, shard_dir: str | Path):
        self.dir = Path(shard_dir)
        manifest = json.loads((self.dir / "manifest.json").read_text())
        self._shards, self._offsets = [], []
        total = 0
        for entry in manifest:
            self._offsets.append(total)
            self._shards.append(entry["file"])
            total += entry["count"]
        self._total = total
        self._cache: dict[int, dict] = {}

    def __len__(self):
        return self._total

    def sequence_lengths(self) -> list[int]:
        """Each sequence's raw frame count, for length-bucketed sampling
        (``data.sampler.dataset_lengths``), without the landmark arrays."""
        out: list[int] = []
        for f in self._shards:
            with np.load(self.dir / f, allow_pickle=True) as z:
                out.extend(int(v) for v in z["lengths"])
        return out

    def _shard_for(self, idx: int) -> tuple[dict, int]:
        s = bisect.bisect_right(self._offsets, idx) - 1
        if s not in self._cache:
            if len(self._cache) > 2:
                self._cache.pop(next(iter(self._cache)))
            with np.load(self.dir / self._shards[s], allow_pickle=True) as z:
                self._cache[s] = {"x": z["x"], "lengths": z["lengths"],
                                  "phrases": z["phrases"]}
        return self._cache[s], idx - self._offsets[s]

    def render(self, idx: int) -> tuple[np.ndarray, str]:
        shard, j = self._shard_for(int(idx))
        T = int(shard["lengths"][j])
        return shard["x"][j, :T], str(shard["phrases"][j])

    def batch(self, indices, tokenizer, max_frames: int = 384,
              max_phrase: int = lm.MAX_PHRASE_LENGTH) -> dict:
        return collate(self, indices, tokenizer, max_frames, max_phrase)
