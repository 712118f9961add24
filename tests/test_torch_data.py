"""The port's corpus readers (``ishara_tpu_torch/data/{dataset,cache}.py``)
against the JAX package's (``tests/test_data_beam.py``,
``tests/test_cache_prefetch.py``,
``test_distributed.py::test_process_sharding_disjoint_cover``) on parquet
files the test writes: render, batch, signer folds, group statistics and
per-sequence normalisation exactly; per-process shards a disjoint cover;
``write_shards`` byte-identical for 1 and 3 workers and across the two
packages; a shard directory written by one package read the same by the
other."""

import numpy as np
import pytest

from ishara_tpu.data import cache as jcache
from ishara_tpu.data import dataset as jdataset
from ishara_tpu.data.tokenizer import CTCTokenizer as JCTCTokenizer

from ishara_tpu_torch.data import cache, dataset
from ishara_tpu_torch.data import landmarks as lm
from ishara_tpu_torch.data.sampler import dataset_lengths
from ishara_tpu_torch.data.synthetic import SyntheticASLFR
from ishara_tpu_torch.data.tokenizer import CTCTokenizer
from ishara_tpu_torch.preprocess import GroupStats


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory):
    """train.csv and two parquet files: 10 sequences of 4 signers, some
    landmark columns missing, one file indexed by ``sequence_id``."""
    import pandas as pd

    root = tmp_path_factory.mktemp("aslfr_torch")
    (root / "train_landmarks").mkdir()
    rng = np.random.default_rng(0)
    rows, frames = [], {7: [], 8: []}
    for seq in range(10):
        fid = 7 if seq < 6 else 8
        rows.append({"path": f"train_landmarks/{fid}.parquet",
                     "file_id": fid, "sequence_id": seq + 1000,
                     "participant_id": 100 + seq % 4,
                     "phrase": ["abc", "de f", "xyz", "hi 5"][seq % 4]})
        for _ in range(5 + seq):
            frame = {"sequence_id": seq + 1000}
            for col in lm.SEL_COLS[: 60 + 20 * (seq % 3)]:
                frame[col] = float(rng.standard_normal())
            frames[fid].append(frame)
    pd.DataFrame(rows).to_csv(root / "train.csv", index=False)
    pd.DataFrame(frames[7]).to_parquet(root / "train_landmarks" / "7.parquet")
    pd.DataFrame(frames[8]).set_index("sequence_id").to_parquet(
        root / "train_landmarks" / "8.parquet")
    return root


@pytest.mark.parametrize("kw", [
    {}, {"preload": True}, {"fold": 1, "split": "train"},
    {"fold": 1, "split": "val"}, {"max_sequences": 3}])
def test_parquet_render_and_batch_match_jax(parquet_dir, kw):
    got, want = dataset.ParquetASLFR(parquet_dir, **kw), \
        jdataset.ParquetASLFR(parquet_dir, **kw)
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        (gx, gp), (wx, wp) = got.render(i), want.render(i)
        assert gp == wp
        np.testing.assert_array_equal(gx, wx)
        assert gx.shape[1] == lm.N_COLS and np.isnan(gx[:, 140:]).all()
    gb = got.batch(range(len(got)), CTCTokenizer(), max_frames=12)
    wb = want.batch(range(len(got)), JCTCTokenizer(), max_frames=12)
    for k in ("raw", "lengths", "labels"):
        np.testing.assert_array_equal(gb[k], wb[k])
    assert gb["phrases"] == wb["phrases"]


def test_signer_folds_partition_by_participant(parquet_dir):
    tr = dataset.ParquetASLFR(parquet_dir, fold=0, split="train")
    va = dataset.ParquetASLFR(parquet_dir, fold=0, split="val")
    assert len(tr) + len(va) == 10
    assert set(tr.df["participant_id"]).isdisjoint(va.df["participant_id"])


def test_process_shards_are_a_disjoint_cover(parquet_dir):
    full = dataset.ParquetASLFR(parquet_dir)
    shards = [dataset.ParquetASLFR(parquet_dir, process_index=i,
                                   process_count=3) for i in range(3)]
    ids = sorted(s for ds in shards for s in ds.df["sequence_id"].tolist())
    assert ids == sorted(full.df["sequence_id"].tolist())
    assert len(ids) == len(set(ids)) == len(full)
    # and as the JAX package cuts them, with folds too
    for i in range(3):
        a = dataset.ParquetASLFR(parquet_dir, process_index=i,
                                 process_count=3, fold=1)
        b = jdataset.ParquetASLFR(parquet_dir, process_index=i,
                                  process_count=3, fold=1)
        assert a.df["sequence_id"].tolist() == b.df["sequence_id"].tolist()


def test_group_stats_and_normalisation_match_jax(parquet_dir):
    ds = dataset.ParquetASLFR(parquet_dir)
    got = dataset.compute_group_stats(ds)
    want = jdataset.compute_group_stats(jdataset.ParquetASLFR(parquet_dir),
                                        num_sequences=None)
    assert isinstance(got, GroupStats)
    for g in lm.GROUPS:
        for a, b in ((got.mean[g], want.mean[g]), (got.std[g], want.std[g])):
            assert tuple(a.shape) == (1, 1, 3)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(0).standard_normal((20, 276)).astype(
        np.float32)
    x[3, 5] = np.nan
    x[:, 7] = 2.0
    np.testing.assert_array_equal(dataset.normalize_per_sequence(x),
                                  jdataset.normalize_per_sequence(x))


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_write_shards_is_byte_identical_and_reads_across_packages(tmp_path):
    ds = SyntheticASLFR(num_sequences=10, frames_per_char=4, seed=2)
    one = cache.write_shards(ds, tmp_path / "one", shard_size=4)
    three = cache.write_shards(ds, tmp_path / "three", shard_size=4,
                               num_workers=3)
    ref = jcache.write_shards(ds, tmp_path / "jax", shard_size=4)
    assert _files(one) == _files(three) == _files(ref)
    assert len(_files(one)) == 4       # three shards and the manifest
    for d in (one, ref):
        got, want = cache.ShardedASLFR(d), jcache.ShardedASLFR(d)
        assert len(got) == len(want) == 10
        assert got.sequence_lengths() == want.sequence_lengths()
        np.testing.assert_array_equal(
            dataset_lengths(got), [ds.render(i)[0].shape[0]
                                   for i in range(10)])
        for i in (0, 4, 9, 5, 1):          # across shards, out of order
            (gx, gp), (wx, wp) = got.render(i), want.render(i)
            assert gp == wp == ds.render(i)[1]
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gx, ds.render(i)[0])
        gb = got.batch([0, 5, 9], CTCTokenizer(), max_frames=64)
        wb = want.batch([0, 5, 9], JCTCTokenizer(), max_frames=64)
        for k in ("raw", "lengths", "labels"):
            np.testing.assert_array_equal(gb[k], wb[k])
