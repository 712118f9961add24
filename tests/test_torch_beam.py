"""The port's CTC prefix beam searches (PyTorch, CPU) against the JAX
package's: the host search beam for beam, the fixed-shape device search id
for id over a grid of (beam width W, symbols a frame K, classes C, max_len,
length) with ties, and the serving engines' beam decode request for request,
the constant-phrase fallback included.

Tolerances: host scores within 1e-6 relative (the same numpy arithmetic);
device scores within 1e-4 relative, as ``tests/test_beam_device.py`` holds
JAX's own search; ids and counts exact everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.data import landmarks as lm
from ishara_tpu.decode import beam as jbeam
from ishara_tpu.decode import beam_device as jbd
from ishara_tpu.serve.engine import BatchedEngine as JBatched
from ishara_tpu.serve.engine import InferenceEngine as JEngine

from ishara_tpu_torch.decode import beam as tbeam
from ishara_tpu_torch.decode import beam_device as tbd
from ishara_tpu_torch.serve.engine import BatchedEngine, InferenceEngine

from torch_port_helpers import jax_model, port_model, raw_sequence, small_config

MAX_RAW = 64


def _log_probs(rng, T, C, scale=3.0):
    x = rng.standard_normal((T, C)).astype(np.float32) * scale
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


@pytest.mark.parametrize("width,top_k,length", [
    (8, 16, None), (4, 5, 13), (1, 3, None), (12, 59, 20)])
def test_host_search_matches_jax(width, top_k, length):
    lp = _log_probs(np.random.default_rng(width), 30, 60)
    want = jbeam.ctc_beam_search(lp, width, 59, length, top_k)
    got = tbeam.ctc_beam_search(lp, width, 59, length, top_k)
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-6)


def test_host_batch_decode_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 25, 60)).astype(np.float32) * 4
    lengths = np.array([25, 11, 1])
    for lens in (None, lengths):
        assert tbeam.beam_decode_batch(logits, 6, lengths=lens) == \
            jbeam.beam_decode_batch(logits, 6, lengths=lens)


def _device_pair(lp, length, W, K, U, blank):
    want = jbd.beam_search_device(
        jnp.asarray(lp), None if length is None else jnp.int32(length),
        beam_width=W, top_k=K, max_len=U, blank_id=blank)
    got = tbd.beam_search_device(
        torch.from_numpy(lp), None if length is None
        else torch.tensor(length, dtype=torch.int32),
        beam_width=W, top_k=K, max_len=U, blank_id=blank)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_same(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    assert int(got[1]) == int(want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)


# (W, K, C, max_len, T, length): the serving geometry, K = C (exact prefix
# search), beams past the symbol count, short max_len (extensions stop at
# U), one beam, length < T and length 1
GRID = [(8, 8, 60, 64, 40, None), (4, 3, 10, 8, 30, 17),
        (3, 10, 10, 5, 25, None), (8, 60, 60, 64, 24, None),
        (16, 4, 6, 64, 20, None), (1, 1, 5, 4, 12, None),
        (5, 4, 6, 3, 20, 9), (8, 8, 60, 64, 30, 1)]


@pytest.mark.parametrize("W,K,C,U,T,length", GRID)
def test_device_search_matches_jax(W, K, C, U, T, length):
    rng = np.random.default_rng(W * 100 + K)
    for blank in (C - 1, 0):
        want, got = _device_pair(_log_probs(rng, T, C), length, W, K, U,
                                 blank)
        _assert_same(want, got)


@pytest.mark.parametrize("W,K", [(4, 3), (8, 8), (3, 12)])
def test_device_search_ties_match_jax(W, K):
    """Uniform frames (every symbol ties) and duplicated columns (pairs of
    symbols tie): which K symbols a frame takes, and which W candidates
    survive, follow ``lax.top_k``'s lower-index order."""
    C, T = 12, 16
    rng = np.random.default_rng(K)
    uniform = np.full((T, C), -np.log(C), np.float32)
    dup = _log_probs(rng, T, C // 2)
    dup = np.repeat(dup, 2, axis=1) - np.float32(np.log(2.0))
    mixed = uniform.copy()
    mixed[::3] = dup[::3]
    for lp in (uniform, dup, mixed):
        for length in (None, 9):
            want, got = _device_pair(lp, length, W, K, 64, C - 1)
            _assert_same(want, got)


def test_device_batch_decode_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 20, 60)).astype(np.float32) * 4
    lengths = np.array([20, 7, 1], np.int32)
    kw = dict(beam_width=4, top_k=6, max_len=16)
    for lens in (None, lengths):
        want = jbd.beam_decode_device_batch(
            jnp.asarray(logits), None if lens is None else jnp.asarray(lens),
            **kw)
        got = tbd.beam_decode_device_batch(
            torch.from_numpy(logits),
            None if lens is None else torch.from_numpy(lens), **kw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_device_search_at_k_equal_c_is_the_exact_host_search():
    """With every symbol a frame, the device search is exact prefix search:
    its best prefix is the host search's at the same width."""
    rng = np.random.default_rng(9)
    for _ in range(3):
        lp = _log_probs(rng, 20, 8, scale=2.0)
        ids, count, score = tbd.beam_search_device(
            torch.from_numpy(lp), beam_width=6, top_k=8, max_len=20,
            blank_id=7)
        best, best_score = tbeam.ctc_beam_search(lp, 6, 7,
                                                 top_k_emissions=8)[0]
        assert tuple(ids[:int(count)].tolist()) == best
        np.testing.assert_allclose(float(score), best_score, rtol=1e-5)


def test_device_search_loop_traces_without_host_sync():
    """The frame loop itself exports (no ``.item()``, no branch on a
    tensor) and the traced loop gives the same result."""
    lp = torch.from_numpy(_log_probs(np.random.default_rng(2), 5, 7))
    length = torch.tensor(4, dtype=torch.int32)

    class Loop(torch.nn.Module):
        def forward(self, lp, length):
            return tbd.search(lp, length, 3, 4, 6, 6)

    ep = torch.export.export(Loop(), (lp, length), strict=False)
    for got, want in zip(ep.module()(lp, length),
                         tbd.search(lp, length, 3, 4, 6, 6)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# --------------------------------------------------------------------------
# The serving engines' beam decode against JAX's
# --------------------------------------------------------------------------

def _requests():
    rng = np.random.default_rng(21)
    return [raw_sequence(rng, 10), raw_sequence(rng, 40),
            raw_sequence(rng, 80), raw_sequence(rng, 30, left_dominant=True),
            raw_sequence(rng, 20, nan_hands=True),
            np.full((15, lm.N_COLS), np.nan, np.float32)]


@pytest.fixture(scope="module")
def models():
    cfg = small_config("hybrid")
    model, variables = jax_model(cfg)
    v = jax.tree_util.tree_map(np.array, variables)
    v["params"]["classifier"]["kernel"] *= 8.0
    probe = jax.tree_util.tree_map(np.array, v)
    probe["params"]["classifier"]["bias"][59] = 1000.0
    return cfg, model, v, probe


BEAM = dict(decode="beam", beam_width=4, beam_top_k=6)


@pytest.mark.parametrize("fused,dma", [(False, False), (True, False),
                                       ("int8", False), (True, True)])
def test_beam_engine_matches_jax(models, fused, dma):
    """Unfused (f32), fused (bf16 weights), int8 and dma (JAX's Pallas
    kernels in interpret mode, the port's plain versions); the
    blank-dominated probe (unfused) serves the fallback on both sides."""
    cfg, model, variables, probe = models
    for v in (variables, probe) if not fused else (variables,):
        want = JEngine(model, v, max_raw_frames=MAX_RAW, fused=fused,
                       dma=dma, **BEAM)
        got = InferenceEngine(port_model(cfg, v), max_raw_frames=MAX_RAW,
                              device="cpu", fused=fused, dma=dma, **BEAM)
        for raw in _requests():
            ids, count = want(raw)
            got_ids, got_count = got(raw)
            assert got_count == count
            np.testing.assert_array_equal(got_ids, ids)
            if v is probe:
                assert count == 11


def test_batched_beam_engine_matches_jax(models):
    cfg, model, variables, _ = models
    reqs = _requests()[:4]
    want = JBatched(model, variables, batch_size=4, max_raw_frames=MAX_RAW,
                    fused=True, **BEAM)(reqs)
    got = BatchedEngine(port_model(cfg, variables), batch_size=4,
                        max_raw_frames=MAX_RAW, fused=True, device="cpu",
                        **BEAM)(reqs)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
