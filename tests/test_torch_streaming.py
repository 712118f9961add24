"""The port's ``StreamingEncoder`` (CPU, f32) -- ``tests/test_streaming.py``
on the port: a sequence fed chunk by chunk gives the logits of the port's
batch causal forward on the whole sequence, and the logits and emitted ids
of JAX's ``StreamingEncoder`` on the same weights, at chunks of 1, 4 and 8,
through invalid (all-zero) frames, with a bounded context, past
``frame_len``; the incremental CTC collapse; the guards.

Tolerance: atol = rtol = 1e-4 (f32; the chunk sums keys and taps in
another order than the batch forward)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.serve.streaming import StreamingEncoder as JStreamingEncoder

import ishara_tpu_torch.config as tcfg
from ishara_tpu_torch.preprocess import GroupStats
from ishara_tpu_torch.preprocess.pipeline import _TABLES
from ishara_tpu_torch.serve import StreamingEncoder, StreamState

from torch_port_helpers import jax_model, port_model, small_config

TOL = dict(rtol=1e-4, atol=1e-4)


def _causal_cfg(**kw):
    base = dict(dim=32, variant="hybrid", num_squeeze_blocks=1,
                num_conform_blocks=1, num_heads=4, frame_len=32,
                transformer_kernel_size=7, expansion_factor=2, top_mult=1,
                causal=True, attn_context=32)
    base.update(kw)
    return small_config(**base)


def _port_cfg(cfg):
    return tcfg.EncoderConfig(**dataclasses.asdict(cfg))


def _raw_frames(rng, T):
    # raw landmarks away from 0, so every frame is valid unless zeroed
    return rng.random((T, 276)).astype(np.float32) * 0.8 + 0.1


def _batch_causal_logits(model, raw):
    """The batch forward on the stream's normalisation (identity stats, no
    resampling): the frames straight into the stem."""
    x = torch.from_numpy(raw[:, _TABLES["out"]])
    with torch.no_grad():
        return model(x[None])[0].numpy()


def _stream(eng, raw, chunk):
    state = eng.init_state()
    logits, ids = [], []
    for i in range(0, raw.shape[0], chunk):
        state, out_ids, _, lg = eng.step(state, raw[i:i + chunk])
        logits.append(lg.numpy())
        ids.append(out_ids)
    return state, np.concatenate(logits), ids


def _jax_stream(cfg, variables, raw, chunk):
    eng = JStreamingEncoder(cfg, variables, chunk_size=chunk)
    state = eng.init_state()
    logits, ids = [], []
    for i in range(0, raw.shape[0], chunk):
        state, out_ids, _, lg = eng.step(state, raw[i:i + chunk])
        logits.append(np.asarray(lg))
        ids.append(np.asarray(out_ids))
    return np.concatenate(logits), ids


@pytest.mark.parametrize("variant,chunk,ctx", [
    ("hybrid", 8, 32), ("hybrid", 4, 32), ("hybrid", 1, 32),
    ("squeezeformer", 8, 32), ("conformer", 8, 32),
    ("hybrid", 4, 12),                 # a window shorter than the stream
])
@pytest.mark.parametrize("invalid", [False, True])
def test_streaming_matches_batch_causal_and_jax(rng, variant, chunk, ctx,
                                                invalid):
    cfg = _causal_cfg(variant=variant, attn_context=ctx)
    _, variables = jax_model(cfg)
    model = port_model(cfg, variables)
    raw = _raw_frames(rng, cfg.frame_len)
    if invalid:
        raw[10:14] = 0.0        # a tracking dropout burst mid-stream
        raw[-4:] = 0.0          # and a trailing one
    want = _batch_causal_logits(model, raw)
    eng = StreamingEncoder(_port_cfg(cfg), model, chunk_size=chunk,
                           device="cpu")
    state, got, ids = _stream(eng, raw, chunk)
    np.testing.assert_allclose(got, want, **TOL)
    jlogits, jids = _jax_stream(cfg, variables, raw, chunk)
    np.testing.assert_allclose(got, jlogits, **TOL)
    for a, b in zip(ids, jids):
        np.testing.assert_array_equal(a.numpy(), b)
    assert isinstance(state, StreamState) and state.pos == cfg.frame_len


def test_streaming_from_a_state_dict_and_bf16_weights(rng):
    """A ``state_dict`` serves as the model does, and a bf16 model streams
    in f32 (the batch forward then at f32 for the comparison)."""
    cfg = _causal_cfg(dtype="bfloat16")
    _, variables = jax_model(cfg)
    model = port_model(cfg, variables)
    f32_model = port_model(dataclasses.replace(cfg, dtype="float32"),
                           variables)
    raw = _raw_frames(rng, cfg.frame_len)
    eng = StreamingEncoder(_port_cfg(cfg), model.state_dict(), chunk_size=8,
                           device="cpu")
    _, got, _ = _stream(eng, raw, 8)
    np.testing.assert_allclose(got, _batch_causal_logits(f32_model, raw),
                               **TOL)


def test_streaming_with_stats_matches_jax(rng):
    """Non-identity normalisation statistics and NaN hands."""
    from ishara_tpu.data import landmarks as lm
    from ishara_tpu.preprocess import GroupStats as JGroupStats

    cfg = _causal_cfg()
    _, variables = jax_model(cfg)
    r = np.random.default_rng(5)
    mean = {g: r.random((1, 1, 3)).astype(np.float32) * 0.2
            for g in lm.GROUPS}
    std = {g: r.random((1, 1, 3)).astype(np.float32) + 0.5
           for g in lm.GROUPS}
    raw = _raw_frames(rng, cfg.frame_len)
    raw[5:9, lm.GROUP_IDX["rhand"].ravel()] = np.nan
    raw[20:22] = np.nan                        # all-NaN frames: invalid
    eng = StreamingEncoder(
        _port_cfg(cfg), port_model(cfg, variables),
        stats=GroupStats(mean={g: torch.from_numpy(v)
                               for g, v in mean.items()},
                         std={g: torch.from_numpy(v) for g, v in std.items()}),
        chunk_size=8, device="cpu")
    _, got, _ = _stream(eng, raw, 8)
    jeng = JStreamingEncoder(cfg, variables, JGroupStats(mean, std),
                             chunk_size=8)
    state, want = jeng.init_state(), []
    for i in range(0, cfg.frame_len, 8):
        state, _, _, lg = jeng.step(state, raw[i:i + 8])
        want.append(np.asarray(lg))
    np.testing.assert_allclose(got, np.concatenate(want), **TOL)


def test_streaming_beyond_frame_len(rng):
    """The stream goes on past frame_len (the batch path's resample
    horizon): state and positional encoding extend to max_positions, and
    the logits stay JAX's."""
    cfg = _causal_cfg(attn_context=16)
    _, variables = jax_model(cfg)
    eng = StreamingEncoder(_port_cfg(cfg), port_model(cfg, variables),
                           chunk_size=8, max_positions=256, device="cpu")
    jeng = JStreamingEncoder(cfg, variables, chunk_size=8, max_positions=256)
    state, jstate = eng.init_state(), jeng.init_state()
    for _ in range(20):                       # 160 frames >> frame_len 32
        chunk = _raw_frames(rng, 8)
        state, _, _, logits = eng.step(state, chunk)
        jstate, _, _, jlogits = jeng.step(jstate, chunk)
        assert np.isfinite(logits.numpy()).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert state.pos == 160


def test_incremental_ctc_collapse(rng):
    """The ids emitted across chunk boundaries equal a greedy collapse of
    the whole argmax sequence."""
    cfg = _causal_cfg(variant="squeezeformer")
    model = port_model(cfg, jax_model(cfg, seed=3)[1])
    raw = _raw_frames(rng, cfg.frame_len)
    ids = _batch_causal_logits(model, raw).argmax(-1)
    want, prev = [], cfg.blank_id
    for t in ids:
        if t != prev and t != cfg.blank_id:
            want.append(int(t))
        prev = int(t)
    eng = StreamingEncoder(_port_cfg(cfg), model, chunk_size=8,
                           device="cpu")
    _, _, emitted = _stream(eng, raw, 8)
    got = StreamingEncoder.collect(emitted)
    assert got == want
    assert eng.decode_text(got) == eng.decode_text(want)


def test_guards(rng):
    cfg = _causal_cfg()
    model = port_model(cfg, jax_model(cfg)[1])
    pcfg = _port_cfg(cfg)
    for bad in (dict(causal=False), dict(attn_context=0),
                dict(dominant_hand=True)):
        with pytest.raises(ValueError):
            StreamingEncoder(dataclasses.replace(pcfg, **bad), model,
                             device="cpu")
    with pytest.raises(ValueError, match="streaming unsupported"):
        StreamingEncoder(dataclasses.replace(pcfg, variant="conv_hybrid"),
                         model, device="cpu")
    # the positional table runs out: raise, never clamp
    eng = StreamingEncoder(dataclasses.replace(pcfg, attn_context=8), model,
                           chunk_size=8, max_positions=16, device="cpu")
    state = eng.init_state()
    state, *_ = eng.step(state, _raw_frames(rng, 8))
    state, *_ = eng.step(state, _raw_frames(rng, 8))
    with pytest.raises(ValueError, match="max_positions"):
        eng.step(state, _raw_frames(rng, 8))
    with pytest.raises(ValueError, match="chunk must be"):
        eng.step(eng.init_state(), _raw_frames(rng, 4))
    # without a card the default device raises (the tests' is the CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingEncoder(pcfg, model)
