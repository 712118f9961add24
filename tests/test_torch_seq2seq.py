"""The port's translation model (``ishara_tpu_torch.models.seq2seq``), its
autoregressive decodes and ``Seq2SeqTokenizer`` against the JAX package's.

Small sizes (dim 32, 4 heads, 2 + 2 layers, T = 12, 30 classes); inputs,
perturbed weights and BatchNorm statistics from numpy seeds, bridged with
``flax_to_state_dict``. Every module and the whole model at f32 within
1e-5 (the same f32 arithmetic in another order; flax's LayerNorm takes
the fast variance, PyTorch's the two-pass one); decoded tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.data.tokenizer import Seq2SeqTokenizer as JaxTokenizer
from ishara_tpu.decode import autoregressive as jar
from ishara_tpu.models import seq2seq as jsq

from ishara_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from ishara_tpu_torch.data.tokenizer import Seq2SeqTokenizer
from ishara_tpu_torch.decode import autoregressive as tar
from ishara_tpu_torch.models import seq2seq as tsq

from torch_port_helpers import (
    port_translation_model,
    translation_models,
    with_eos_bias,
)

TOL = 1e-5
D, H, C, T, S = 32, 4, 30, 12, 7


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _build(encoder_type):
    return translation_models(encoder_type, dim=D, heads=H, classes=C, T=T,
                              S=S)


@pytest.fixture(scope="module")
def squeeze():
    return _build("squeezeformer")


@pytest.fixture(scope="module")
def conformer():
    return _build("conformer")


def _sub(v, *path):
    """{"params": ..., "batch_stats": ...} of the sub-module at ``path``."""
    out = {}
    for col in ("params", "batch_stats"):
        tree = v.get(col, {})
        for p in path:
            tree = tree.get(p, {})
        if tree:
            out[col] = tree
    return out


def _h(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("group", ["face", "rhand", "lhand", "pose"])
def test_feature_extractor(squeeze, group):
    """Conv over the landmark axis (k 3, SAME), BN eps 1e-3, relu, the mean
    over landmarks, Dense(d / 4)."""
    _, v, pm, *_ = squeeze
    L = {"face": 40, "rhand": 21, "lhand": 21, "pose": 10}[group]
    x = _h((2, T, L, 3))
    want = jsq.FeatureExtractor(D // 4).apply(_sub(v, f"{group}_extractor"),
                                              jnp.asarray(x))
    with torch.no_grad():
        got = getattr(pm, f"{group}_extractor")(torch.from_numpy(x))
    _close(got, want)


def test_rope_tables_and_rotation():
    """The numpy tables (divisor max(half - 1, 1)) bit for bit; the
    half-split rotation within 1e-6."""
    for hd in (2, 8, 26):
        for a, b in zip(tsq.rope_tables(hd, 20), jsq.rope_tables(hd, 20)):
            np.testing.assert_array_equal(a, b)
    q, k = _h((2, 5, 3, 8)), _h((2, 5, 3, 8), seed=2)
    sin, cos = jsq.rope_tables(8, 5)
    want = jsq.apply_rope(jnp.asarray(q), jnp.asarray(k),
                          sin[None, :, None], cos[None, :, None])
    got = tsq.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(sin)[None, :, None],
                         torch.from_numpy(cos)[None, :, None])
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_rope_attention(squeeze, masked):
    """q/k/v/out with bias, Dh**-0.5, finfo.min masking (an all-padding row
    gives uniform weights, no NaN)."""
    _, v, pm, _, mask, _ = squeeze
    x = _h((2, T, D))
    m = mask if masked else None
    want = jsq.RoPEMultiHeadAttention(D, H).apply(
        {"params": v["params"]["squeezeformer_layers_0"]["mhsa"]},
        jnp.asarray(x), None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got = pm.squeezeformer_layers[0].mhsa(
            torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    assert torch.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("part", ["conv", "ff1", "ff2"])
def test_block_parts(squeeze, part):
    """The conv module (pw 2d, GLU, dw k 3, BN eps 1e-5, SiLU, pw) and the
    FFNs (4d, SiLU)."""
    _, v, pm, *_ = squeeze
    x = _h((2, T, D))
    block = pm.squeezeformer_layers[0]
    mod = (jsq._ConvModule(D, 0.0) if part == "conv"
           else jsq._FF(D, 0.0))
    want = mod.apply(_sub(v, "squeezeformer_layers_0", part),
                     jnp.asarray(x))
    with torch.no_grad():
        got = getattr(block, part)(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("encoder_type", ["squeezeformer", "conformer"])
def test_encoder_block(squeeze, conformer, encoder_type):
    """A whole block with its one shared residual ``scale``."""
    _, v, pm, _, mask, _ = squeeze if encoder_type == "squeezeformer" \
        else conformer
    block_cls = {"squeezeformer": jsq.RoPESqueezeformerBlock,
                 "conformer": jsq.RoPEConformerBlock}[encoder_type]
    x = _h((2, T, D))
    want = block_cls(D, H, 0.0).apply(_sub(v, "squeezeformer_layers_1"),
                                      jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = pm.squeezeformer_layers[1](torch.from_numpy(x),
                                         torch.from_numpy(mask))
    _close(got, want)


def test_decoder_layer_prefix_step_and_cross_kv(squeeze):
    """``__call__`` over a causal prefix, ``cross_kv``, and ``step`` (cache
    row ``pos`` written, rows <= pos visible) position by position."""
    _, v, pm, _, mask, _ = squeeze
    layer = jsq.DecoderLayer(D, H, 0.0)
    p = {"params": v["params"]["decoder_layers_0"]}
    tgt, mem = _h((2, S, D)), _h((2, T, D), seed=3)
    want = layer.apply(p, jnp.asarray(tgt), jnp.asarray(mem),
                       jnp.asarray(mask))
    tl = pm.decoder_layers[0]
    with torch.no_grad():
        got = tl(torch.from_numpy(tgt), torch.from_numpy(mem),
                 torch.from_numpy(mask))
        _close(got, want)
        kx, vx = tl.cross_kv(torch.from_numpy(mem))
        jkx, jvx = layer.apply(p, jnp.asarray(mem), method=layer.cross_kv)
        _close(kx, jkx)
        _close(vx, jvx)
        kc = torch.zeros((2, S, H, D // H))
        vc = torch.zeros_like(kc)
        m = torch.from_numpy(mask)
        for pos in range(S):
            out, kc, vc = tl.step(torch.from_numpy(tgt[:, pos:pos + 1]), pos,
                                  kc, vc, kx, vx, m)
            _close(out[:, 0], np.asarray(want)[:, pos])


@pytest.mark.parametrize("encoder_type", ["squeezeformer", "conformer"])
@pytest.mark.parametrize("method", ["encode", "decode", "decode_step",
                                    "forward", "forward_no_tgt"])
def test_model(squeeze, conformer, encoder_type, method):
    """The whole model: encode (confidence from position 0 whatever the
    mask), decode, decode_step against decode's positions, forward."""
    jm, v, pm, x, mask, tgt = squeeze if encoder_type == "squeezeformer" \
        else conformer
    xt, mt, tt = (torch.from_numpy(x), torch.from_numpy(mask),
                  torch.from_numpy(tgt))
    jx, jmask, jtgt = jnp.asarray(x), jnp.asarray(mask), jnp.asarray(tgt)
    with torch.no_grad():
        if method == "encode":
            want = jm.apply(v, jx, jmask, method=jm.encode)
            got = pm.encode(xt, mt)
        elif method in ("decode", "decode_step"):
            mem = _h((2, T, D), seed=4)
            wlog = jm.apply(v, jtgt, jnp.asarray(mem), jmask,
                            method=jm.decode)
            if method == "decode":
                want, got = (wlog,), (pm.decode(tt, torch.from_numpy(mem),
                                                mt),)
            else:
                cross = pm.cross_kv(torch.from_numpy(mem))
                caches = [(torch.zeros((2, S, H, D // H)),
                           torch.zeros((2, S, H, D // H)))
                          for _ in range(2)]
                got, want = [], []
                for pos in range(S):
                    logits, caches = pm.decode_step(tt[:, pos], pos, caches,
                                                    cross, mt)
                    got.append(logits)
                    want.append(np.asarray(wlog)[:, pos])
        elif method == "forward":
            want = jm.apply(v, jx, jmask, jtgt)
            got = pm(xt, mt, tt)
        else:
            want = jm.apply(v, jx, jmask)
            got = pm(xt, mt)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


def test_bridge_round_trip(squeeze):
    """flax -> state_dict -> flax gives every leaf back unchanged: the
    ``embedding`` [C, d] untransposed, the blocks' bare ``scale``."""
    _, v, pm, *_ = squeeze
    sd = flax_to_state_dict(v)
    assert sd["target_embedding.embedding"].shape == (C, D)
    assert sd["squeezeformer_layers.0.scale"].shape == (1,)
    assert sd["decoder_layers.1.sa_q.weight"].shape == (D, D)
    back = state_dict_to_flax(pm.state_dict())
    for path, a in jax.tree_util.tree_leaves_with_path(v):
        b = back
        for k in path:
            b = b[k.key]
        np.testing.assert_array_equal(np.asarray(a), b)


def _decode_setup(squeeze, eos_bias=None):
    jm, v, pm, x, mask, _ = squeeze
    if eos_bias is not None:
        v = with_eos_bias(v, eos_bias)
        pm = port_translation_model(v, num_classes=C, feature_dim=D,
                                    num_layers=2, num_decoder_layers=2,
                                    num_heads=H)
    return jm, v, pm, x[:1], mask[:1]


@pytest.mark.parametrize("eos_bias", [None, 100.0])
def test_greedy_decodes(squeeze, eos_bias):
    """greedy_translate (the full-prefix oracle) and greedy_translate_cached
    (early exit on and off) give the JAX package's tokens."""
    jm, v, pm, x, mask = _decode_setup(squeeze, eos_bias)
    jx, jmask = jnp.asarray(x), jnp.asarray(mask)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    want, wconf = jar.greedy_translate_cached(jm, v, jx, jmask, max_len=10)
    want = np.asarray(want)
    if eos_bias:
        assert want[0, :3].tolist() == [1, 2, 0]
    for got, conf in (tar.greedy_translate(pm, xt, mt, max_len=10),
                      tar.greedy_translate_cached(pm, xt, mt, max_len=10),
                      tar.greedy_translate_cached(pm, xt, mt, max_len=10,
                                                  early_exit=False)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        _close(conf, wconf)


@pytest.mark.parametrize("width,penalty", [(1, 0.0), (3, 0.0), (3, 0.5)])
def test_beam_decode(squeeze, width, penalty):
    """beam_translate_cached: tokens exactly, score within 1e-5."""
    jm, v, pm, x, mask = _decode_setup(squeeze)
    want, wconf, wscore = jar.beam_translate_cached(
        jm, v, jnp.asarray(x), jnp.asarray(mask), max_len=10,
        beam_width=width, length_penalty=penalty)
    got, conf, score = tar.beam_translate_cached(
        pm, torch.from_numpy(x), torch.from_numpy(mask), max_len=10,
        beam_width=width, length_penalty=penalty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(score, wscore)
    _close(conf, wconf)


def test_top_w_is_stable():
    """Ties go to the smallest flat index, as jax.lax.top_k's do."""
    total = torch.tensor([[0.5, 1.0, -np.inf], [1.0, 0.5, 1.0]])
    vals, idx = tar.top_w(total, 3)
    assert idx.tolist() == [1, 3, 5]
    assert vals.tolist() == [1.0, 1.0, 1.0]


def test_seq2seq_tokenizer():
    """ids, truncation that keeps sos / eos, decode stopping at eos."""
    ours, ref = Seq2SeqTokenizer(), JaxTokenizer()
    assert ours.vocab_size == ref.vocab_size == 62
    for text, n in (("hello world", None), ("a-b c", 12), ("x" * 30, 8),
                    ("", 4)):
        np.testing.assert_array_equal(ours.encode(text, n),
                                      ref.encode(text, n))
    ids = ours.encode("abc", 10)
    ids[5] = 5                                # after eos: ignored
    assert ours.decode(ids) == ref.decode(ids) == "abc"
