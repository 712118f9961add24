"""Thin real-time serving clients (port of ``ishara_tpu/serve/clients.py``):
rebuilds of the reference's ``inference tests/`` scripts (inference_v2/v3,
image_inference, real_time_tracking) against the port's engine instead of a
TFLite interpreter.

MediaPipe/OpenCV are optional extras (not part of the framework's core
dependency set, exactly as in the reference where they're standalone
scripts); every entry point degrades with a clear error if they're missing.
The framework boundary is landmark tensors — these clients only do camera
capture + MediaPipe landmark extraction + drawing.
"""

from __future__ import annotations

import numpy as np

import torch

from ..data import landmarks as lm


def _require(modname: str):
    try:
        return __import__(modname)
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            f"{modname} is required for this client (pip install {modname}); "
            "the core framework does not depend on it"
        ) from e


def mediapipe_to_frame(results, pose_results=None, face_results=None) -> np.ndarray:
    """Convert MediaPipe Holistic/Hands results to one [276] frame in
    SEL_COLS order (missing landmarks -> NaN), mirroring the reference's
    column contract (image_inference.py:19-44)."""
    frame = np.full((lm.N_COLS,), np.nan, np.float32)

    def put(prefix, idx, landmark):
        col = lm.SEL_COLS.index(f"x_{prefix}_{idx}")
        frame[col] = landmark.x
        frame[col + lm.N_LANDMARKS] = landmark.y
        frame[col + 2 * lm.N_LANDMARKS] = landmark.z

    if getattr(results, "right_hand_landmarks", None):
        for i, pt in enumerate(results.right_hand_landmarks.landmark):
            put("right_hand", i, pt)
    if getattr(results, "left_hand_landmarks", None):
        for i, pt in enumerate(results.left_hand_landmarks.landmark):
            put("left_hand", i, pt)
    if getattr(results, "pose_landmarks", None):
        for i in lm.POSE:
            put("pose", i, results.pose_landmarks.landmark[i])
    if getattr(results, "face_landmarks", None):
        for i in lm.LIP:
            put("face", i, results.face_landmarks.landmark[i])
    return frame


def nan_filter_left_hand_flip(frames: np.ndarray) -> np.ndarray:
    """inference_v3.py semantics: if the left hand has more signal than the
    right, mirror x and swap hands so the dominant hand is 'right' — the
    exact mirror used by the fused training/serving canonicalization
    (preprocess.pipeline.mirror_lr / dominant_hand_mirror)."""
    from ..preprocess.pipeline import mirror_lr

    rh = frames[:, lm.GROUP_IDX["rhand"][:, 0]]
    lh = frames[:, lm.GROUP_IDX["lhand"][:, 0]]
    if np.isnan(lh).sum() < np.isnan(rh).sum():
        x = torch.as_tensor(np.asarray(frames, np.float32))
        return mirror_lr(x).numpy()
    return frames


def topk_classes(engine, raw_frames: np.ndarray, tokenizer, k: int = 3):
    """Top-k (token, probability) over the frame-averaged class softmax —
    the reference image client's diagnostic surface
    (image_inference.py:66-72 prints the top-3 class indices/probs of the
    model output). Runs the engine's model (its float weights, whatever the
    engine's ``fused`` mode) on the preprocessed window on the engine's
    device; the decoded-text path stays the serving program. Equal
    probabilities rank by the lower class index."""
    from ..preprocess.pipeline import preprocess

    x = torch.as_tensor(np.asarray(raw_frames, np.float32),
                        device=engine.device)
    x = preprocess(x, raw_frames.shape[0], engine.stats, engine.frame_len)
    with torch.no_grad():
        logits = engine.model(x[None])
    probs = torch.softmax(logits[0].to(torch.float32), dim=-1).mean(dim=0)
    top_i = torch.sort(probs, descending=True, stable=True).indices[:k]
    top_p = probs[top_i]
    return [(tokenizer.decode(np.asarray([i])), float(p))
            for i, p in zip(top_i.cpu().numpy(), top_p.cpu().numpy())]


def predict_from_image(engine, tokenizer, image_path: str,
                       top_k: int = 0):
    """Static-image prediction (image_inference.py): one MediaPipe frame ->
    engine -> text. With ``top_k`` > 0 also returns the top-k
    (token, probability) list the reference script prints
    (image_inference.py:66-72)."""
    cv2 = _require("cv2")
    mp = _require("mediapipe")

    img = cv2.cvtColor(cv2.imread(image_path), cv2.COLOR_BGR2RGB)
    with mp.solutions.holistic.Holistic(static_image_mode=True) as holistic:
        results = holistic.process(img)
    frame = mediapipe_to_frame(results)
    text = engine.predict_text(frame[None, :], tokenizer)
    if top_k > 0:
        return text, topk_classes(engine, frame[None, :], tokenizer, top_k)
    return text


def run_webcam(engine, tokenizer, window_frames: int = 64,
               camera_index: int = 0, draw: bool = True,
               capture=None, extractor=None) -> list[str]:
    """Live webcam loop (real_time_tracking.py:57-92 / inference_v2.py):
    sliding window of landmark frames -> engine -> overlay text. Returns the
    emitted predictions (one per full window).

    ``capture`` and ``extractor`` are injectable so the loop runs without a
    camera (the tests drive it with a fake frame source):

    * ``capture``: ``.read() -> (ok, img)`` / ``.release()`` (default:
      ``cv2.VideoCapture(camera_index)``);
    * ``extractor``: ``img -> results`` where results is either a MediaPipe
      Holistic result (converted via :func:`mediapipe_to_frame`) or already
      a raw [276] landmark frame (default: MediaPipe Holistic over the
      BGR->RGB converted image).
    """
    cv2 = mp = None
    if capture is None or extractor is None or draw:
        cv2 = _require("cv2")
    if extractor is None:
        mp = _require("mediapipe")
        holistic = mp.solutions.holistic.Holistic()

        def extractor(img):
            return holistic.process(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))

    cap = capture if capture is not None else cv2.VideoCapture(camera_index)
    buf: list[np.ndarray] = []
    texts: list[str] = []
    text = ""
    try:
        while True:
            ok, img = cap.read()
            if not ok:
                break
            results = extractor(img)
            frame = (results if isinstance(results, np.ndarray)
                     else mediapipe_to_frame(results))
            buf.append(frame)
            if len(buf) > window_frames:
                buf.pop(0)
            if len(buf) == window_frames:
                seq = nan_filter_left_hand_flip(np.stack(buf))
                text = engine.predict_text(seq, tokenizer)
                texts.append(text)
            if draw:
                # mp is only imported when no extractor was injected; an
                # injected extractor can still hand back MediaPipe-style
                # results, so guard the landmark overlay on mp itself
                if mp is not None and getattr(
                        results, "right_hand_landmarks", None):
                    mp.solutions.drawing_utils.draw_landmarks(
                        img, results.right_hand_landmarks)
                cv2.putText(img, text, (10, 40),
                            cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
                cv2.imshow("ishara-tpu", img)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        if hasattr(cap, "release"):
            cap.release()
        if draw:
            cv2.destroyAllWindows()
    return texts
