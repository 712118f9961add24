"""The port's native batched Levenshtein (``ishara_tpu_torch/native/``)
against the JAX package's (``ishara_tpu.native``, ``tests/test_native.py``)
and the port's Python DP: it builds here with ``g++``, gives exactly the
same distances on random pairs from the reference test's alphabet, on
empty strings and on code points beyond ASCII and beyond the BMP; when the
build fails ``available()`` is false and the DP answers; the corpus scores
of ``normalized_levenshtein`` equal the reference's in all three modes.
"""

import numpy as np
import pytest

from ishara_tpu import native as jnative
from ishara_tpu.evaluation.metrics import (
    normalized_levenshtein as j_normalized_levenshtein,
)

from ishara_tpu_torch import native
from ishara_tpu_torch.evaluation import metrics
from ishara_tpu_torch.evaluation.metrics import levenshtein

ALPHABET = list("abcdefg -")
EXTRA = [("", ""), ("", "abc"), ("abc", ""), ("héllo", "hello"),
         ("é", "e"), ("a\U0001F600b", "ab"), ("\U0001F600", "\U0001F601"),
         ("naïve café", "naive cafe"), ("ü" * 30, "u" * 29)]


def _pairs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a, b = rng.integers(0, 20, 2)
        out.append(("".join(rng.choice(ALPHABET, a)),
                    "".join(rng.choice(ALPHABET, b))))
    return out + EXTRA


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The module with its cache forgotten, building into ``tmp_path``;
    restored (and forgotten again) afterwards."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.reset()
    yield native
    native.reset()


def test_the_library_builds_here(fresh_native):
    assert fresh_native.available()
    built = list((fresh_native.BUILD_DIR).glob("liblevenshtein-*.so"))
    assert len(built) == 1 and not list(fresh_native.BUILD_DIR.glob("*.tmp"))
    # keyed by the source: loading again builds nothing new
    fresh_native.reset()
    assert fresh_native.available()
    assert list(fresh_native.BUILD_DIR.glob("*")) == built


def test_distances_equal_the_reference_and_the_dp():
    pairs = _pairs()
    preds, targets = (list(x) for x in zip(*pairs))
    assert native.available() and jnative.available()
    got = native.batch_levenshtein(preds, targets)
    assert got.dtype == np.int32 and got.shape == (len(pairs),)
    np.testing.assert_array_equal(got,
                                  jnative.batch_levenshtein(preds, targets))
    np.testing.assert_array_equal(
        got, [levenshtein(p, t) for p, t in pairs])
    # an empty batch, and a batch of empty strings only
    assert native.batch_levenshtein([], []).shape == (0,)
    np.testing.assert_array_equal(native.batch_levenshtein(["", ""],
                                                           ["", "ab"]),
                                  [0, 2])


@pytest.mark.parametrize("breaks", ["compiler", "source"])
def test_a_failed_build_falls_back_to_the_dp(fresh_native, monkeypatch,
                                             tmp_path, breaks):
    if breaks == "compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    else:
        bad = tmp_path / "levenshtein.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SRC", bad)
    assert not native.available()
    pairs = _pairs(50, seed=1)
    preds, targets = (list(x) for x in zip(*pairs))
    np.testing.assert_array_equal(
        native.batch_levenshtein(preds, targets),
        [levenshtein(p, t) for p, t in pairs])
    assert not list(native.BUILD_DIR.glob("*.so"))


@pytest.mark.parametrize("mode", ["competition", "max_len", "pooled"])
def test_normalized_levenshtein_equals_the_reference(mode):
    pairs = _pairs(120, seed=2)
    preds, targets = (list(x) for x in zip(*pairs))
    assert metrics.normalized_levenshtein(preds, targets, mode) \
        == j_normalized_levenshtein(preds, targets, mode)
    with pytest.raises(ValueError):
        metrics.normalized_levenshtein(preds, targets[:-1], mode)


def test_corpus_distances_go_through_the_native_library(monkeypatch):
    calls = []
    real = native.batch_levenshtein

    def spy(p, t):
        calls.append(len(p))
        return real(p, t)

    monkeypatch.setattr(native, "batch_levenshtein", spy)
    assert metrics.character_error_rate(["abc", "x"], ["abd", "y"]) == 0.5
    assert calls == [2]
