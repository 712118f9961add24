"""The port's translation engines (``ishara_tpu_torch.serve.
translation_engine``) against the JAX package's on raw requests: every
``TranslationEngine`` mode and ``BatchedTranslationEngine``.

Small sizes (dim 32, 4 heads, 2 + 2 layers, 30 classes, frame_len 16,
``max_raw_frames`` 64, ``max_out`` 10); weights from numpy seeds, bridged.
Requests: an ordinary one, one with NaN hands, one all NaN, one shorter
than a frame_len, one longer than ``max_raw_frames``. Tokens exactly,
confidence within 1e-5 (f32 in another summation order).
"""

import numpy as np
import pytest

from ishara_tpu.serve import translation_engine as jte

from ishara_tpu_torch.ops.decoder_kernel import DecoderFitError
from ishara_tpu_torch.serve import translation_engine as tte

from torch_port_helpers import raw_sequence, translation_models

FRAME_LEN, MAX_RAW, MAX_OUT = 16, 64, 10
MODES = {
    "oracle": dict(kv_cache=False),
    "cached": dict(),
    "cached_no_exit": dict(early_exit=False),
    "fused": dict(fused=True),
    "auto": dict(fused="auto"),
    "beam": dict(decode="beam", beam_width=3),
    "beam_penalty": dict(decode="beam", beam_width=3, length_penalty=0.5),
    "beam_fused": dict(decode="beam", beam_width=3, fused=True),
}
KW = dict(frame_len=FRAME_LEN, max_raw_frames=MAX_RAW, max_out=MAX_OUT)


@pytest.fixture(scope="module")
def setup():
    jm, v, pm, *_ = translation_models(dim=32, heads=4, classes=30,
                                       T=FRAME_LEN, seed=5)
    rng = np.random.default_rng(11)
    nan_hands = raw_sequence(rng, 40, nan_hands=True)
    reqs = [raw_sequence(rng, 30), nan_hands,
            np.full((20, 276), np.nan, np.float32), raw_sequence(rng, 5),
            raw_sequence(rng, MAX_RAW + 20)]
    return jm, v, pm, reqs, {}


def _jax_outputs(setup, mode):
    """The JAX engine's (tokens, confidence) per request, built once a
    mode."""
    jm, v, _, reqs, cache = setup
    if mode not in cache:
        eng = jte.TranslationEngine(jm, v, **KW, **MODES[mode])
        cache[mode] = [eng(r) for r in reqs]
    return cache[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax(setup, mode):
    _, _, pm, reqs, _ = setup
    eng = tte.TranslationEngine(pm, **KW, **MODES[mode], device="cpu")
    for raw, (want, wconf) in zip(reqs, _jax_outputs(setup, mode)):
        got, conf = eng(raw)
        assert got.dtype == np.int32 and got.shape == (MAX_OUT,)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(conf, wconf, rtol=1e-5, atol=1e-5)


def test_batched_engine_matches_jax(setup):
    jm, v, pm, reqs, _ = setup
    reqs = reqs[:4]
    want, wconf = jte.BatchedTranslationEngine(jm, v, batch_size=4,
                                               **KW)(reqs)
    got, conf = tte.BatchedTranslationEngine(pm, batch_size=4, **KW,
                                             device="cpu")(reqs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(conf, wconf, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="expected 4 sequences"):
        tte.BatchedTranslationEngine(pm, batch_size=4, **KW,
                                     device="cpu")(reqs[:3])


def test_predict_text(setup):
    from ishara_tpu_torch.data.tokenizer import Seq2SeqTokenizer

    _, _, pm, reqs, _ = setup
    eng = tte.TranslationEngine(pm, **KW, device="cpu")
    text, conf = eng.predict_text(reqs[0], Seq2SeqTokenizer())
    tokens, conf2 = eng(reqs[0])
    assert text == Seq2SeqTokenizer().decode(tokens) and conf == conf2


@pytest.mark.parametrize("kw,error", [
    (dict(decode="sample"), ValueError),
    (dict(decode="beam", kv_cache=False), ValueError),
    (dict(fused="int8"), ValueError),
    # the kernel takes at most num_classes beams: an explicit fused=True
    # raises where the reference's wrapper falls back
    (dict(decode="beam", beam_width=31, fused=True), DecoderFitError),
])
def test_engine_argument_errors(setup, kw, error):
    _, _, pm, _, _ = setup
    with pytest.raises(error):
        tte.TranslationEngine(pm, **KW, **kw, device="cpu")


def test_auto_chooses_the_loop_where_the_kernel_cannot_go(setup):
    """``fused="auto"`` with a beam width the kernel does not take runs the
    unfused beam loop, openly, and still matches JAX's tokens."""
    _, _, pm, reqs, _ = setup
    kw = dict(decode="beam", beam_width=31)   # over the 30 classes
    eng = tte.TranslationEngine(pm, **KW, **kw, fused="auto", device="cpu")
    ref = tte.TranslationEngine(pm, **KW, **kw, device="cpu")
    for raw in reqs[:2]:
        np.testing.assert_array_equal(eng(raw)[0], ref(raw)[0])
