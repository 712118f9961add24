"""The port's training loop against the JAX package's, at a tiny size on the
CPU: the ``Trainer`` (three epochs with validation, from the JAX Trainer's
own initial weights carried over by ``bridge.load_train_state``), the
length-bucketed sampler, the evaluation harness on both packages' engines,
the metric logger and prefetch, and the hard-corpus runner
``tools/train_hard_torch.py``.

Tolerances of the Trainer comparison (dropout and augmentation off, f32):
each epoch's train loss and the validation loss rtol 1e-3 (the steps after
the first carry the earlier updates' rounding differences, as in
``test_torch_train_step.py``'s six steps); the three validation scores
exactly, the decoded strings being the same; the final state to the
tolerances of ``test_six_fused_train_steps_match_jax`` (six steps here
too: two an epoch)."""

import dataclasses
import json
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ishara_tpu.config import IsharaConfig as JIsharaConfig
from ishara_tpu.config import TrainConfig as JTrainConfig
from ishara_tpu.data.sampler import BucketSampler as JBucketSampler
from ishara_tpu.data.synthetic import SyntheticASLFR as JSyntheticASLFR
from ishara_tpu.data.tokenizer import CTCTokenizer as JCTCTokenizer
from ishara_tpu.evaluation.harness import (
    dominant_hand_filter as j_dominant_hand_filter,
)
from ishara_tpu.evaluation.harness import run_harness as j_run_harness
from ishara_tpu.serve.engine import InferenceEngine as JEngine
from ishara_tpu.train import Trainer as JTrainer
from ishara_tpu.utils.logging import MetricLogger as JMetricLogger

import ishara_tpu_torch.config as tconfig
from ishara_tpu_torch.bridge import load_train_state
from ishara_tpu_torch.data.sampler import BucketSampler, dataset_lengths
from ishara_tpu_torch.data.synthetic import SyntheticASLFR
from ishara_tpu_torch.data.tokenizer import CTCTokenizer
from ishara_tpu_torch.evaluation.harness import (
    HarnessResult,
    dominant_hand_filter,
    run_harness,
)
from ishara_tpu_torch.evaluation.metrics import normalized_levenshtein
from ishara_tpu_torch.serve.engine import InferenceEngine
from ishara_tpu_torch.train import Trainer
from ishara_tpu_torch.utils import MetricLogger, Throughput, trace
from ishara_tpu_torch.utils.prefetch import prefetch

from test_torch_train_step import assert_states_match
from torch_port_helpers import (
    jax_model,
    port_model,
    raw_sequence,
    small_config,
    to_numpy,
)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# The Trainer against JAX's
# ---------------------------------------------------------------------------

def _configs():
    """(JAX config, port config) from one dict: hybrid 1 + 1, dim 64,
    frame_len 32, dropout and augmentation off, batch 8, 3 epochs validated
    every epoch."""
    model = dataclasses.asdict(small_config(
        "hybrid", frame_len=32, num_squeeze_blocks=1, num_conform_blocks=1))
    train = dict(batch_size=8, num_epochs=3, warmup_epochs=0, lr_max=4e-3,
                 validate_every_epochs=1, checkpoint_every_epochs=100,
                 aug_prob=0.0)
    jcfg = JIsharaConfig(model=JIsharaConfig().model.__class__(**model),
                         train=JTrainConfig(**train))
    tcfg = tconfig.IsharaConfig(model=tconfig.EncoderConfig(**model),
                                train=tconfig.TrainConfig(**train))
    return jcfg, tcfg


def _data(package_synthetic):
    kw = dict(frames_per_char=5, min_phrase=2, max_phrase=4)
    return (package_synthetic(num_sequences=16, seed=3, **kw),
            package_synthetic(num_sequences=8, seed=4, **kw))


def test_trainer_matches_jax_trainer(tmp_path):
    jcfg, tcfg = _configs()
    jtrain, jval = _data(JSyntheticASLFR)
    jt = JTrainer(jcfg, jtrain, jval, JCTCTokenizer(),
                  workdir=tmp_path / "jax", max_raw_frames=64)
    tt = Trainer(tcfg, *_data(SyntheticASLFR), CTCTokenizer(),
                 workdir=tmp_path / "port", max_raw_frames=64, device="cpu")
    load_train_state(tt.state, to_numpy({"params": jt.state.params,
                                         "batch_stats": jt.state.batch_stats}))
    assert tt.cfg.train.steps_per_epoch == jt.cfg.train.steps_per_epoch == 2
    jh, th = jt.train(), tt.train()
    assert [r["epoch"] for r in th] == [r["epoch"] for r in jh] == [0, 1, 2]
    for j, t in zip(jh, th):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"],
                                   rtol=1e-3)
        np.testing.assert_allclose(t["val_loss"], j["val_loss"], rtol=1e-3)
        for k in ("val_score", "val_score_maxlen", "val_score_pooled"):
            assert t[k] == j[k], k
    assert_states_match(tt.state, jt.state, atol=1e-5, share=0.995,
                        moment_tol=3e-2)
    assert tt.best_score == jt.best_score
    assert tt.ckpt.latest_step() == jt.ckpt.latest_step() == 6
    assert tt.ckpt.best_step() == jt.ckpt.best_step()


def test_trainer_runs_on_cuda_by_default_and_refuses_unported_branches(
        tmp_path, monkeypatch):
    _, tcfg = _configs()
    train, val = _data(SyntheticASLFR)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tcfg, train, val, CTCTokenizer(), workdir=tmp_path)
    with pytest.raises(NotImplementedError, match="translation training"):
        Trainer(tcfg, train, val, CTCTokenizer(), workdir=tmp_path,
                task="translation", device="cpu")
    with pytest.raises(NotImplementedError, match="distribution"):
        Trainer(tcfg, train, val, CTCTokenizer(), workdir=tmp_path,
                mesh=object(), device="cpu")


def test_trainer_histograms_and_validation_tail(tmp_path):
    """``histogram_every_steps`` logs gradient and parameter histograms
    through the instrumented step; a validation set that the batch does not
    divide pads its tail batch and scores only the real rows."""
    _, tcfg = _configs()
    tcfg.train.histogram_every_steps = 2
    train, _ = _data(SyntheticASLFR)
    val = SyntheticASLFR(num_sequences=11, seed=4, frames_per_char=5,
                         min_phrase=2, max_phrase=4)
    tt = Trainer(tcfg, train, val, CTCTokenizer(), workdir=tmp_path,
                 max_raw_frames=64, device="cpu")
    tt.train_epoch(0, seed=0)
    recs = [json.loads(line) for line in
            (tmp_path / "train_metrics.jsonl").read_text().splitlines()]
    hists = [r["histograms"] for r in recs if "histograms" in r]
    assert len(hists) == 2       # batch 0: gradients, then parameters
    names = set(tt.state.param_dict())
    assert {k.split("/", 1)[1] for k in hists[0] if k.startswith("grad/")} \
        == names
    assert {k.split("/", 1)[1] for k in hists[1] if k.startswith("param/")} \
        == names
    out = tt.validate()
    assert len(out["examples"]) == 11
    # the same score as the eleven sequences alone, padded rows dropped
    preds, targets = map(list, zip(*out["examples"]))
    assert out["val_score"] == normalized_levenshtein(preds, targets)
    assert targets == [val.render(i)[1] for i in range(11)]


# ---------------------------------------------------------------------------
# BucketSampler: the reference's batches, and its own tests' cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,boundaries,batch", [
    (0, (96, 192, 384), 16), (1, (64, 128, 256), 8), (7, (200,), 4),
    (42, (50, 100, 150, 200, 400), 32)])
def test_bucket_sampler_matches_reference(seed, boundaries, batch):
    lengths = np.random.default_rng(seed).integers(10, 400, size=300)
    ours = BucketSampler(lengths, batch, boundaries, seed=seed)
    ref = JBucketSampler(lengths, batch, boundaries, seed=seed)
    for epoch in range(4):
        got, want = ours.batches(epoch), ref.batches(epoch)
        assert len(got) == len(want)
        for (gi, gc), (wi, wc) in zip(got, want):
            assert gc == wc
            np.testing.assert_array_equal(gi, wi)


def _buckets_respect_boundaries():
    lengths = np.random.default_rng(0).integers(10, 400, size=500)
    batches = BucketSampler(lengths, 16, (96, 192, 384), seed=1).batches(0)
    assert batches
    seen = set()
    for idx, cap in batches:
        assert cap in (96, 192, 384) and len(idx) == 16
        for i in idx:
            assert i not in seen
            seen.add(i)
            if cap < 384:
                assert lengths[i] <= cap
    assert len(lengths) - len(seen) < 16


def _small_buckets_spill_up_not_lost():
    lengths = np.asarray([50] * 10 + [150] * 64)
    s = BucketSampler(lengths, 16, (96, 192), seed=0)
    covered = set()
    for epoch in range(3):
        for idx, cap in s.batches(epoch):
            covered.update(int(i) for i in idx)
            if any(i < 10 for i in idx):
                assert cap == 192
    assert covered >= set(range(10))


def _deterministic_and_epoch_varying():
    s = BucketSampler(np.arange(1, 201), 8, (64, 128, 256), seed=7)
    a, b, c = s.batches(0), s.batches(0), s.batches(1)
    assert all((x[0] == y[0]).all() and x[1] == y[1] for x, y in zip(a, b))
    assert any((x[0] != y[0]).any() for x, y in zip(a, c))


def _rejects_bad_boundaries():
    with pytest.raises(ValueError):
        BucketSampler([1, 2], 1, ())
    with pytest.raises(ValueError):
        BucketSampler([1, 2], 1, (128, 64))


def _dataset_lengths_fallback():
    ds = SyntheticASLFR(num_sequences=20, seed=0, max_phrase=4)
    np.testing.assert_array_equal(dataset_lengths(ds),
                                  [ds.render(i)[0].shape[0]
                                   for i in range(20)])

    class WithMetadata:
        def sequence_lengths(self):
            return [3, 1, 2]

    np.testing.assert_array_equal(dataset_lengths(WithMetadata()), [3, 1, 2])


@pytest.mark.parametrize("case", [
    _buckets_respect_boundaries, _small_buckets_spill_up_not_lost,
    _deterministic_and_epoch_varying, _rejects_bad_boundaries,
    _dataset_lengths_fallback], ids=lambda f: f.__name__.strip("_"))
def test_sampler_reference_cases(case):
    """The cases of ``tests/test_sampler.py`` on the port's sampler."""
    case()


def test_trainer_buckets_smoke(tmp_path):
    """With ``bucket_boundaries`` the schedule is the sampler's, the LR
    schedule is sized to its batch count, and an epoch trains."""
    _, tcfg = _configs()
    tcfg.train.batch_size = 4
    tcfg.train.bucket_boundaries = (64, 128)
    ds = SyntheticASLFR(num_sequences=16, seed=0, max_phrase=4)
    tr = Trainer(tcfg, ds, ds, CTCTokenizer(), workdir=tmp_path,
                 max_raw_frames=128, device="cpu")
    ref = JBucketSampler(dataset_lengths(ds), 4, (64, 128), seed=42)
    assert tcfg.train.steps_per_epoch == len(ref.batches(0))
    assert np.isfinite(tr.train_epoch(0, seed=0))
    caps = {cap for _, cap in tr._epoch_indices(0)}
    assert caps <= {64, 128} and caps


# ---------------------------------------------------------------------------
# The evaluation harness on both packages' engines
# ---------------------------------------------------------------------------

class _Requests:
    """Eight raw sequences with the reference's missing-hand NaNs (one
    left-dominant, one with both hands missing throughout) and phrases."""

    def __init__(self):
        rng = np.random.default_rng(5)
        self.seqs = [raw_sequence(rng, T, nan_hands=(i == 5),
                                  left_dominant=(i == 3))
                     for i, T in enumerate((12, 30, 44, 20, 60, 25, 8, 36))]
        self.phrases = ["abc", "hello", "a", "xyz world", "fingerspell",
                        "no hands", "q", "ishara"]

    def __len__(self):
        return len(self.seqs)

    def render(self, i):
        return self.seqs[i], self.phrases[i]


def test_run_harness_matches_jax():
    cfg = small_config("hybrid")
    model, variables = jax_model(cfg)
    v = jax.tree_util.tree_map(np.array, variables)
    v["params"]["classifier"]["kernel"] *= 20.0   # margins over rounding
    data = _Requests()
    want = j_run_harness(JEngine(model, v, max_raw_frames=64), data,
                         JCTCTokenizer(), warmup=1)
    got = run_harness(InferenceEngine(port_model(cfg, v), max_raw_frames=64,
                                      device="cpu"),
                      data, CTCTokenizer(), warmup=1)
    assert isinstance(got, HarnessResult)
    assert got.examples == want.examples
    assert got.num_sequences == want.num_sequences == 8
    for k in ("score", "score_maxlen", "score_pooled"):
        assert getattr(got, k) == getattr(want, k), k
    assert set(got.as_dict()) == set(want.as_dict())
    for y_mul in (0.5, 1.0, 3.0):
        assert dominant_hand_filter(data, range(8), y_mul) \
            == j_dominant_hand_filter(data, range(8), y_mul)
    kept = dominant_hand_filter(data, range(8))
    assert run_harness(InferenceEngine(port_model(cfg, v), max_raw_frames=64,
                                       device="cpu"), data, CTCTokenizer(),
                       apply_filter=True, warmup=0).num_sequences == len(kept)


def test_run_harness_translation_branch():
    """``translation=True`` reads (ids, confidence) and decodes all ids."""

    class Engine:
        def __call__(self, raw):
            return np.asarray([3, 4, 5], np.int32), 0.5

    class Tok:
        def decode(self, ids):
            return "".join("abcdefg"[int(i) - 3] for i in ids)

    got = run_harness(Engine(), _Requests(), Tok(), num_sequences=3,
                      translation=True, warmup=0)
    want = j_run_harness(Engine(), _Requests(), Tok(), num_sequences=3,
                         translation=True, warmup=0)
    assert got.examples == want.examples == [("abc", p) for p in
                                            ("abc", "hello", "a")]
    assert got.score == want.score


# ---------------------------------------------------------------------------
# MetricLogger, Throughput, trace, prefetch
# ---------------------------------------------------------------------------

def test_metric_logger_records_match_reference(tmp_path, capsys):
    leaves = {"w": np.linspace(-1, 2, 50, dtype=np.float32),
              "bad": np.full(4, np.nan, np.float32)}
    for cls, d in ((MetricLogger, "port"), (JMetricLogger, "jax")):
        log = cls(tmp_path / d, print_every=1)
        log.log({"train_loss": 1.5, "epoch": 0}, step=3)
        log.log({"val_score": 0.25})
        tree = ({k: torch.from_numpy(v) for k, v in leaves.items()}
                if cls is MetricLogger else leaves)
        log.log_histograms(tree, step=3, prefix="grad")
        log.close()
    port, ref = [[json.loads(line) for line in
                  (tmp_path / d / "train_metrics.jsonl").read_text()
                  .splitlines()] for d in ("port", "jax")]
    assert [set(r) for r in port] == [set(r) for r in ref]
    hp, hr = port[2]["histograms"], ref[2]["histograms"]
    assert hp["grad/bad"] == hr["grad/bad"] == {"nonfinite": 4}
    assert hp["grad/w"] == hr["grad/w"]
    assert set(hp["grad/w"]) == {"counts", "lo", "hi", "norm"}
    assert "val_score=0.25" in capsys.readouterr().err


def test_throughput_and_trace(tmp_path):
    tp = Throughput(window=3)
    assert tp.update(10) == 0.0
    time.sleep(0.01)
    assert tp.update(10) > 0.0
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())


def test_prefetch_raises_the_workers_error_and_stops_when_abandoned():
    def failing():
        yield 1
        raise ValueError("worker failed")

    it = prefetch(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="worker failed"):
        next(it)

    made, threads = [], []

    def endless():
        threads.append(threading.current_thread())
        i = 0
        while True:
            made.append(i)
            yield i
            i += 1

    it = prefetch(endless(), depth=2)
    assert [next(it), next(it)] == [0, 1]
    it.close()                      # the consumer abandons the generator
    threads[0].join(timeout=5.0)
    assert not threads[0].is_alive()
    assert len(made) <= 5           # depth 2 ahead, then it stopped
    assert list(prefetch(iter(range(5)), depth=1)) == list(range(5))


# ---------------------------------------------------------------------------
# The hard-corpus runner
# ---------------------------------------------------------------------------

def test_train_hard_runner_reaches_its_harness_lines(tmp_path, capsys,
                                                    monkeypatch):
    """The runner end to end on the CPU, its preset 4 cut to dim 32 and one
    block a stack (the recipe's other settings as the runner sets them)."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import train_hard_torch
    finally:
        sys.path.pop(0)
    preset = tconfig.baseline_config

    def small(index):
        cfg = preset(index)
        cfg.model = dataclasses.replace(
            cfg.model, dim=32, num_heads=4, num_squeeze_blocks=1,
            num_conform_blocks=1, frame_len=32)
        return cfg

    monkeypatch.setattr(tconfig, "baseline_config", small)
    train_hard_torch.main([
        "--device", "cpu", "--epochs", "1", "--sequences", "8",
        "--batch-size", "4", "--val-sequences", "2",
        "--max-raw-frames", "128",
        "--workdir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    for name in ("f32", "bf16", "int8"):
        assert f"harness[{name}]:" in out
    assert "int8 gap vs f32:" in out
    gate = json.loads(out.strip().splitlines()[-1])["gate"]
    assert set(gate["harness"]) == {"f32", "bf16", "int8"}
    assert gate["steps"] == 2 and gate["gate_passed"] is False
