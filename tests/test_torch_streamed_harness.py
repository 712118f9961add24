"""The causal gate's streamed harness score (``tools/train_hard_torch.py
--causal``, its ``StreamedEngine``) is the reference's own.

The gate scores the causal flagship twice: through the f32 bundle's
``InferenceEngine``, which resamples each sequence to ``frame_len`` before
the encoder, and through ``StreamingEncoder``, which takes the raw frames at
their own rate, chunk by chunk. The second scored lower. Here a few
hard-corpus sequences go through ``StreamedEngine`` over the port's
streamer and over the JAX package's, fed the same way (NaN-padded to whole
chunks, a fresh state, ``collect``), from the same bridged causal weights:
the emitted ids are the same, sequence for sequence, and so is the harness
score. So the gap between the two scores belongs to the reference's
streaming path, not to the port.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from ishara_tpu.serve.streaming import StreamingEncoder as JStreamingEncoder

import ishara_tpu_torch.config as tcfg
from ishara_tpu_torch.data.synthetic import HardSyntheticASLFR
from ishara_tpu_torch.data.tokenizer import CTCTokenizer
from ishara_tpu_torch.evaluation.harness import run_harness
from ishara_tpu_torch.serve import StreamingEncoder

from torch_port_helpers import jax_model, port_model, small_config

ROOT = Path(__file__).resolve().parents[1]


def _streamed_engine():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import train_hard_torch
    finally:
        sys.path.pop(0)
    return train_hard_torch.StreamedEngine


@pytest.fixture(scope="module")
def engines():
    cfg = small_config(dim=32, variant="hybrid", num_squeeze_blocks=1,
                       num_conform_blocks=1, num_heads=4, frame_len=32,
                       transformer_kernel_size=7, expansion_factor=2,
                       causal=True, attn_context=32)
    _, variables = jax_model(cfg, seed=5)
    model = port_model(cfg, variables)
    streamed = _streamed_engine()
    port = streamed(StreamingEncoder(
        tcfg.EncoderConfig(**dataclasses.asdict(cfg)), model, chunk_size=8,
        device="cpu"))
    ref = streamed(JStreamingEncoder(cfg, variables, chunk_size=8))
    return port, ref


def test_streamed_ids_equal_the_reference_streamers(engines):
    port, ref = engines
    ds = HardSyntheticASLFR(num_sequences=6, seed=1, proto_seed=7)
    emitted = 0
    for i in range(len(ds)):
        raw, _ = ds.render(i)
        assert np.isnan(raw).any()          # hand dropouts mid-stream
        ids, n = port(raw)
        jids, jn = ref(raw)
        assert n == jn and np.array_equal(ids, np.asarray(jids)), i
        emitted += n
    assert emitted > 0


def test_streamed_harness_score_equals_the_references(engines):
    port, ref = engines
    ds = HardSyntheticASLFR(num_sequences=6, seed=1, proto_seed=7)
    tok = CTCTokenizer()
    got = run_harness(port, ds, tok, num_sequences=6, warmup=0)
    want = run_harness(ref, ds, tok, num_sequences=6, warmup=0)
    assert got.score == want.score
    assert got.num_sequences == want.num_sequences == 6
