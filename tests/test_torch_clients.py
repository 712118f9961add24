"""The port's serving clients (``ishara_tpu_torch.serve.clients``): the
MediaPipe frame layout and the left-hand flip against the JAX package's,
the webcam loop with a fake capture against a direct engine call, and
``topk_classes`` against the JAX client's (tokens exactly, probabilities
within 1e-5)."""

from types import SimpleNamespace

import jax
import numpy as np

from ishara_tpu.data import landmarks as jlm
from ishara_tpu.serve import clients as jclients
from ishara_tpu.serve.engine import InferenceEngine as JEngine

from ishara_tpu_torch.data import landmarks as lm
from ishara_tpu_torch.data.synthetic import SyntheticASLFR
from ishara_tpu_torch.data.tokenizer import CTCTokenizer
from ishara_tpu_torch.serve import clients
from ishara_tpu_torch.serve.engine import InferenceEngine

from torch_port_helpers import jax_model, port_model, raw_sequence, small_config


def fake_results(right=True, left=False):
    def hand(scale):
        return SimpleNamespace(landmark=[
            SimpleNamespace(x=scale * 0.1 * i, y=0.2 * i, z=0.3 * i)
            for i in range(21)])

    pose = SimpleNamespace(landmark=[
        SimpleNamespace(x=0.5 + 0.01 * i, y=0.5, z=0.0) for i in range(33)])
    face = SimpleNamespace(landmark=[
        SimpleNamespace(x=0.4, y=0.6 - 0.001 * i, z=0.1)
        for i in range(478)])
    return SimpleNamespace(
        right_hand_landmarks=hand(1.0) if right else None,
        left_hand_landmarks=hand(0.5) if left else None,
        pose_landmarks=pose, face_landmarks=face)


def test_mediapipe_to_frame_layout_matches_jax():
    for right, left in ((True, False), (False, True), (True, True)):
        res = fake_results(right, left)
        frame = clients.mediapipe_to_frame(res)
        np.testing.assert_array_equal(frame, jclients.mediapipe_to_frame(res))
    frame = clients.mediapipe_to_frame(fake_results(True, False))
    assert frame.shape == (lm.N_COLS,)
    assert np.isfinite(frame[lm.GROUP_IDX["rhand"][:, 0]]).all()
    assert np.isnan(frame[lm.GROUP_IDX["lhand"][:, 0]]).all()
    i = lm.SEL_COLS.index("x_right_hand_1")
    assert frame[i + lm.N_LANDMARKS] == np.float32(0.2)


def test_nan_filter_flip_matches_jax():
    rng = np.random.default_rng(3)
    left = raw_sequence(rng, 9, left_dominant=True)
    right = raw_sequence(rng, 9)
    for x in (left, right):
        np.testing.assert_array_equal(clients.nan_filter_left_hand_flip(x),
                                      jclients.nan_filter_left_hand_flip(x))
    x = np.full((5, lm.N_COLS), np.nan, np.float32)
    x[:, lm.GROUP_IDX["lhand"][:, 0]] = 0.25
    out = clients.nan_filter_left_hand_flip(x)
    np.testing.assert_allclose(out[:, lm.GROUP_IDX["rhand"][:, 0]], 0.75)
    assert np.isnan(out[:, jlm.GROUP_IDX["lhand"][:, 0]]).all()


class FakeCapture:
    """cv2.VideoCapture stand-in: serves ``n`` dummy images then EOF."""

    def __init__(self, n):
        self.n, self.served, self.released = n, 0, False

    def read(self):
        if self.served >= self.n:
            return False, None
        self.served += 1
        return True, np.zeros((4, 4, 3), np.uint8)

    def release(self):
        self.released = True


def _engine():
    cfg = small_config("squeezeformer", num_squeeze_blocks=1, dim=32,
                       frame_len=16)
    model, variables = jax_model(cfg)
    return cfg, model, variables


def test_run_webcam_loop_executes_with_fake_capture():
    """The capture -> landmarks -> engine loop runs >= 10 full windows on
    the port's engine, no camera, cv2 or mediapipe needed."""
    cfg, _, variables = _engine()
    engine = InferenceEngine(port_model(cfg, variables), max_raw_frames=32,
                             max_out=8, device="cpu")
    tok = CTCTokenizer()
    seq = SyntheticASLFR(num_sequences=1, seed=11).render(0)[0]
    window, fed = 12, []

    def extractor(img):
        frame = np.asarray(seq[len(fed) % len(seq)], np.float32)
        fed.append(frame)
        return frame

    cap = FakeCapture(window + 14)
    texts = clients.run_webcam(engine, tok, window_frames=window, draw=False,
                               capture=cap, extractor=extractor)
    assert cap.released and len(fed) == window + 14
    assert len(texts) == 15 and all(isinstance(t, str) for t in texts)
    final = clients.nan_filter_left_hand_flip(np.stack(fed[-window:]))
    assert texts[-1] == engine.predict_text(final, tok)


def test_topk_classes_matches_jax():
    cfg, model, variables = _engine()
    v = jax.tree_util.tree_map(np.array, variables)
    v["params"]["classifier"]["bias"][3] = v["params"]["classifier"][
        "bias"][5]          # two classes tie on the bias
    want_engine = JEngine(model, v, max_raw_frames=32, max_out=8)
    engine = InferenceEngine(port_model(cfg, v), max_raw_frames=32,
                             max_out=8, device="cpu", fused="int8")
    tok = CTCTokenizer()
    rng = np.random.default_rng(6)
    for raw in (raw_sequence(rng, 20), raw_sequence(rng, 1)):
        want = jclients.topk_classes(want_engine, raw, tok, k=5)
        got = clients.topk_classes(engine, raw, tok, k=5)
        assert [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([p for _, p in got], [p for _, p in want],
                                   rtol=1e-5)
