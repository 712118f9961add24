"""The port's serving engine and greedy decode (PyTorch, CPU) against the JAX
package's: the same ids and counts on the same requests, the all-NaN request
and the constant-phrase fallback included.

The model's classifier weights are scaled up so that frame argmax margins
dwarf the bf16 path's ~1% logit error: ids are then compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.data import landmarks as lm
from ishara_tpu.decode.greedy import greedy_decode as jgreedy
from ishara_tpu.serve.engine import InferenceEngine as JEngine

import ishara_tpu_torch.config as tcfg
from ishara_tpu_torch.data.tokenizer import CTCTokenizer
from ishara_tpu_torch.decode.greedy import greedy_decode as tgreedy
from ishara_tpu_torch.serve.engine import BatchedEngine, InferenceEngine

from torch_port_helpers import jax_model, port_model, raw_sequence, small_config

MAX_RAW = 64


def _requests():
    rng = np.random.default_rng(21)
    return [raw_sequence(rng, 10), raw_sequence(rng, 24),
            raw_sequence(rng, 40), raw_sequence(rng, 80),
            raw_sequence(rng, 30, left_dominant=True),
            raw_sequence(rng, 20, nan_hands=True),
            np.full((15, lm.N_COLS), np.nan, np.float32)]


def _scaled(variables):
    v = jax.tree_util.tree_map(np.array, variables)
    v["params"]["classifier"]["kernel"] *= 20.0
    return v


@pytest.fixture(scope="module")
def models():
    cfg = small_config("hybrid")
    model, variables = jax_model(cfg)
    return cfg, model, _scaled(variables)


def _port(cfg, variables, **kw):
    return InferenceEngine(port_model(cfg, variables),
                           max_raw_frames=MAX_RAW, device="cpu", **kw)


def test_unfused_and_fused_f32_match_jax(models):
    cfg, model, variables = models
    want = JEngine(model, variables, max_raw_frames=MAX_RAW)
    ports = [_port(cfg, variables),
             _port(cfg, variables, fused=True, compute_dtype=torch.float32)]
    for raw in _requests():
        ids, count = want(raw)
        for eng in ports:
            got_ids, got_count = eng(raw)
            assert got_count == count
            np.testing.assert_array_equal(got_ids, ids)


def test_fused_bf16_matches_jax_fused(models):
    """The deploy numerics on both sides: bf16 weights, JAX kernels in
    interpret mode, the port's plain versions."""
    cfg, model, variables = models
    want = JEngine(model, variables, max_raw_frames=MAX_RAW, fused=True)
    port = _port(cfg, variables, fused=True)
    for raw in _requests():
        ids, count = want(raw)
        got_ids, got_count = port(raw)
        assert got_count == count
        np.testing.assert_array_equal(got_ids, ids)


@pytest.mark.parametrize("max_out", [64, 8])
def test_fallback_probe(models, max_out):
    """A blank-dominated decode (< 3 chars) serves the constant phrase,
    cropped when max_out is below its 11 ids."""
    cfg, model, variables = models
    probe = jax.tree_util.tree_map(np.array, variables)
    probe["params"]["classifier"]["bias"][59] = 1000.0
    raw = _requests()[2]
    ids, count = JEngine(model, probe, max_raw_frames=MAX_RAW,
                         max_out=max_out)(raw)
    tok = CTCTokenizer()
    for fused in (False, True):
        eng = _port(cfg, probe, fused=fused, max_out=max_out)
        got_ids, got_count = eng(raw)
        assert got_count == count == min(11, max_out)
        np.testing.assert_array_equal(got_ids, ids)
        if max_out == 64:
            assert eng.predict_text(raw, tok) == "2 a-e -aroe"


def test_batched_engine_matches_inference_engine(models):
    cfg, _, variables = models
    reqs = _requests()[:4]
    single = _port(cfg, variables, fused=True)
    batched = BatchedEngine(port_model(cfg, variables), batch_size=4,
                            max_raw_frames=MAX_RAW, fused=True, device="cpu")
    ids, counts = batched(reqs)
    for i, raw in enumerate(reqs):
        want_ids, want_count = single(raw)
        assert counts[i] == want_count
        np.testing.assert_array_equal(ids[i], want_ids)


def test_unported_options_raise(models):
    cfg, _, variables = models
    for kw in ({"decode": "beam"}, {"fused": "int8"},
               {"fused": True, "dma": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port(cfg, variables, **kw)


@pytest.mark.parametrize("T,max_len", [(30, 64), (30, 16), (64, 64)])
@pytest.mark.parametrize("ties", [False, True])
def test_greedy_decode_matches_jax(T, max_len, ties):
    rng = np.random.default_rng(T + max_len + ties)
    if ties:  # few distinct values: argmax ties go to the first index
        logits = rng.integers(0, 3, (T, 60)).astype(np.float32)
    else:
        logits = rng.standard_normal((T, 60)).astype(np.float32)
        logits[rng.random(T) < 0.3, 59] += 5.0  # blank runs
        logits[5:9] = logits[5]  # a repeated run
    for length in (None, T, T // 2, 1):
        jl = None if length is None else jnp.int32(length)
        tl = None if length is None else torch.tensor(length)
        ids, count = jgreedy(jnp.asarray(logits), max_len=max_len, length=jl)
        got_ids, got_count = tgreedy(torch.from_numpy(logits),
                                     max_len=max_len, length=tl)
        assert int(got_count) == int(count)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))


def test_config_json_round_trips_between_packages(tmp_path):
    from ishara_tpu.config import IsharaConfig, baseline_config

    text = baseline_config(5).to_json()
    assert tcfg.baseline_config(5).to_json() == text
    path = tmp_path / "config.json"
    path.write_text(text)
    port = tcfg.IsharaConfig.from_json(path)
    assert port.model == tcfg.baseline_config(5).model
    port.to_json(path)
    assert IsharaConfig.from_json(path).to_json() == text
