"""Synthetic ASLFR-like data generator: the port's own copy of
``ishara_tpu/data/synthetic.py`` (numpy only; the same seed gives the same
bytes in both packages).

The real Kaggle parquet dataset is not distributed with the reference; this
module provides a *learnable* stand-in with the same tensor contract
([T, 276] raw landmarks + phrase strings): each character is assigned a fixed
prototype hand configuration, a phrase renders as a sequence of noisy
prototype frames with NaN dropout -- so CTC training on it actually converges,
which backs the overfit tests and the training smoke run.
"""

from __future__ import annotations

import numpy as np

from . import landmarks as lm
from .vocab import ASLFR_CHARS


class SyntheticASLFR:
    """Deterministic synthetic corpus keyed by (seed, index)."""

    def __init__(
        self,
        num_sequences: int = 512,
        seed: int = 0,
        frames_per_char: int = 8,
        min_phrase: int = 3,
        max_phrase: int = 10,
        noise: float = 0.05,
        nan_frac: float = 0.05,
        charset: str = ASLFR_CHARS.strip() or ASLFR_CHARS,
        proto_seed: int | None = None,
    ):
        """``seed`` draws the phrases (and, unless ``proto_seed`` is given,
        the character prototypes). Train/val splits of the same task must
        share ``proto_seed`` and differ in ``seed`` — different prototype
        tables are different languages."""
        self.num_sequences = num_sequences
        self.frames_per_char = frames_per_char
        self.noise = noise
        self.nan_frac = nan_frac
        self.charset = charset
        root = np.random.default_rng(seed if proto_seed is None else proto_seed)
        # one prototype frame (all 276 features) per character
        self.prototypes = {
            c: root.standard_normal(lm.N_COLS).astype(np.float32) * 0.5 + 0.5
            for c in charset
        }
        self._seed = seed
        self._phrase_rng = np.random.default_rng(seed + 1)
        self.phrases = [
            "".join(
                self._phrase_rng.choice(list(charset))
                for _ in range(self._phrase_rng.integers(min_phrase, max_phrase + 1))
            )
            for _ in range(num_sequences)
        ]

    def __len__(self):
        return self.num_sequences

    def render(self, idx: int) -> tuple[np.ndarray, str]:
        """-> ([T, 276] float32 with NaNs, phrase)."""
        phrase = self.phrases[idx % self.num_sequences]
        # stable per-(seed, idx) stream — python hash() is process-salted
        rng = np.random.default_rng((self._seed * 1_000_003 + idx) % (2**32))
        frames = []
        for c in phrase:
            proto = self.prototypes[c]
            n = self.frames_per_char + int(rng.integers(-2, 3))
            block = proto[None, :] + rng.standard_normal(
                (max(n, 2), lm.N_COLS)
            ).astype(np.float32) * self.noise
            frames.append(block)
        x = np.concatenate(frames, axis=0)
        drop = rng.random(x.shape) < self.nan_frac
        x[drop] = np.nan
        return x, phrase

    def batch(
        self, indices, tokenizer, max_frames: int = 384,
        max_phrase: int = lm.MAX_PHRASE_LENGTH,
    ) -> dict:
        """Host-side collate: pad raw frames, tokenize phrases."""
        xs = np.zeros((len(indices), max_frames, lm.N_COLS), np.float32)
        lens = np.zeros((len(indices),), np.int32)
        labels = np.full((len(indices), max_phrase), tokenizer.pad_idx, np.int32)
        phrases = []
        for i, idx in enumerate(indices):
            x, phrase = self.render(idx)
            T = min(x.shape[0], max_frames)
            xs[i, :T] = x[:T]
            lens[i] = T
            ids = tokenizer.encode(phrase, max_len=max_phrase)
            labels[i] = ids
            phrases.append(phrase)
        return {"raw": xs, "lengths": lens, "labels": labels, "phrases": phrases}


class HardSyntheticASLFR(SyntheticASLFR):
    """Hard-mode synthetic corpus: same tensor contract, statistics shaped
    like the real ASLFR parquet data so the convergence gate can actually
    fail (VERDICT r3 next-round #2). Differences from the easy corpus:

    * **Information lives in the dominant hand only.** Characters are
      fingerspelled handshapes: 63 dominant-hand features per prototype;
      lips/pose carry no phrase signal (idle drift), matching the real
      task where ``character_to_prediction_index`` chars are fingerspelled.
    * **Confusable handshapes.** Prototypes are drawn as small offsets from
      a handful of base shapes (real fingerspelling confusion sets like
      r/u/v, m/n/s), separation controlled by ``confusability`` in [0, 1)
      (0 = easy/orthogonal, 0.9 = near-identical within a cluster).
    * **Handedness skew.** Each sequence has a signer with a dominant hand
      (``left_frac`` left-dominant, the real corpus's minority); the
      non-dominant hand is missing (NaN) in most frames.
    * **Group-burst NaNs.** Landmarks drop out per GROUP per FRAME in
      Markov bursts (tracking loss), not per-scalar — hands frequently
      (p ~ ``hand_nan``), lips/pose rarely, exactly like MediaPipe output.
    * **Signer/camera variation.** Per-sequence global translate+scale and
      per-signer speed (frames-per-char scale), which the preprocessing
      normalization must undo.
    * **Coarticulation.** Linear blend frames between consecutive
      characters; double letters get a shrunken second segment (the real
      double-letter bounce), stressing CTC blank separation.
    * **Realistic phrases.** Lengths and character distribution follow the
      reference train.csv content (addresses / phone numbers / URLs:
      digit-heavy, plus ``-./ @`` separators and lowercase words).
    """

    def __init__(
        self,
        num_sequences: int = 512,
        seed: int = 0,
        frames_per_char: int = 8,
        confusability: float = 0.6,
        left_frac: float = 0.15,
        hand_nan: float = 0.15,
        other_nan: float = 0.02,
        noise: float = 0.06,
        proto_seed: int | None = None,
    ):
        self.num_sequences = num_sequences
        self.frames_per_char = frames_per_char
        self.confusability = float(confusability)
        self.left_frac = float(left_frac)
        self.hand_nan = float(hand_nan)
        self.other_nan = float(other_nan)
        self.noise = float(noise)
        self.charset = ASLFR_CHARS
        self._seed = seed
        root = np.random.default_rng(
            seed if proto_seed is None else proto_seed)

        # --- dominant-hand prototypes on a clustered handshape manifold ---
        n_hand_feats = 3 * lm.N_HAND  # 63
        n_chars = len(ASLFR_CHARS)
        n_base = max(6, n_chars // 5)  # ~12 base handshapes
        bases = root.standard_normal((n_base, n_hand_feats)).astype(
            np.float32) * 0.25
        assign = root.integers(0, n_base, size=n_chars)
        offsets = root.standard_normal((n_chars, n_hand_feats)).astype(
            np.float32)
        offsets /= np.linalg.norm(offsets, axis=1, keepdims=True)
        sep = 0.5 * (1.0 - self.confusability)
        self.hand_protos = bases[assign] + offsets * sep  # [n_chars, 63]
        self.char_to_id = {c: i for i, c in enumerate(ASLFR_CHARS)}
        # idle (non-informative) templates for lips / pose / resting hand
        self.idle = root.standard_normal(lm.N_COLS).astype(np.float32) * 0.2

        self._phrase_rng = np.random.default_rng(seed + 1)
        self.phrases = [self._draw_phrase() for _ in range(num_sequences)]
        # rendering is host-CPU heavy (per-frame Markov NaN chains); on the
        # 1-core bench host an uncached epoch would serialize with device
        # dispatch, so rendered sequences are memoized (~500 KB each)
        self._cache: dict[int, tuple[np.ndarray, str]] = {}

    # phrase templates follow the reference train.csv content classes
    def _draw_phrase(self) -> str:
        r = self._phrase_rng
        kind = r.random()
        if kind < 0.35:  # phone number
            sep = r.choice([" ", "-"])
            parts = ["".join(r.choice(list("0123456789"))
                             for _ in range(r.integers(3, 5)))
                     for _ in range(r.integers(2, 4))]
            return sep.join(parts)
        if kind < 0.70:  # street address
            num = "".join(r.choice(list("0123456789"))
                          for _ in range(r.integers(1, 5)))
            words = [
                "".join(r.choice(list("abcdefghijklmnopqrstuvwxyz"))
                        for _ in range(r.integers(3, 9)))
                for _ in range(r.integers(1, 3))
            ]
            return num + " " + " ".join(words)
        # url-ish
        host = "".join(r.choice(list("abcdefghijklmnopqrstuvwxyz"))
                       for _ in range(r.integers(4, 10)))
        tld = r.choice(["com", "org", "net", "edu"])
        path = "".join(r.choice(list("abcdefghijklmnopqrstuvwxyz0123456789"))
                       for _ in range(r.integers(0, 6)))
        s = host + "." + tld
        return s + "/" + path if path else s

    def _burst_nan(self, rng, T: int, p: float) -> np.ndarray:
        """[T] bool: Markov bursts with stationary rate ~p (tracking loss
        persists for a few frames once it starts)."""
        stay = 0.6  # P(missing stays missing)
        enter = p * (1.0 - stay) / max(1.0 - p, 1e-6)
        out = np.zeros(T, bool)
        m = rng.random() < p
        for t in range(T):
            out[t] = m
            m = (rng.random() < stay) if m else (rng.random() < enter)
        return out

    def render(self, idx: int) -> tuple[np.ndarray, str]:
        idx = idx % self.num_sequences
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        phrase = self.phrases[idx]
        rng = np.random.default_rng(
            (self._seed * 1_000_003 + idx) % (2**32))
        left_dom = rng.random() < self.left_frac
        speed = rng.uniform(0.65, 1.5)        # signer speed
        scale = rng.uniform(0.8, 1.25)        # camera zoom
        shift = rng.standard_normal(3).astype(np.float32) * 0.3

        # per-character handshape segments with coarticulation blends
        hand_frames = []
        prev_shape = None
        prev_c = None
        for c in phrase:
            shape = self.hand_protos[self.char_to_id[c]]
            n = max(2, int(round(self.frames_per_char * speed
                                 + rng.integers(-2, 3))))
            if prev_c is not None and c == prev_c:
                n = max(2, n // 2)             # double-letter bounce
            if prev_shape is not None:
                for w in (0.33, 0.67):         # transition frames
                    hand_frames.append(
                        (1 - w) * prev_shape + w * shape
                        + rng.standard_normal(shape.shape).astype(np.float32)
                        * self.noise * 2.0)
            hold = shape[None, :] + rng.standard_normal(
                (n, shape.shape[0])).astype(np.float32) * self.noise
            hand_frames.extend(hold)
            prev_shape, prev_c = shape, c
        hand = np.stack(hand_frames, axis=0)   # [T, 63]
        T = hand.shape[0]

        # assemble the flat frame: idle everywhere + dominant-hand signal
        x = (self.idle[None, :]
             + rng.standard_normal((T, lm.N_COLS)).astype(np.float32)
             * self.noise * 0.5)
        dom, rest = ("lhand", "rhand") if left_dom else ("rhand", "lhand")
        dom_cols = lm.GROUP_IDX[dom].reshape(-1)     # [63] (n, 3) flattened
        x[:, dom_cols] = hand.reshape(T, lm.N_HAND, 3).reshape(T, -1)

        # camera transform (undone by per-group normalization downstream);
        # columns are laid out X-block + Y-block + Z-block (landmarks.py),
        # so the per-coordinate shift repeats per 92-wide block
        x = x * scale + np.repeat(shift, lm.N_LANDMARKS)

        # group-burst NaNs: resting hand mostly missing, dominant hand in
        # tracking-loss bursts, lips/pose rarely
        for g, p in (
            (dom, self.hand_nan),
            (rest, 0.85),
            ("lip", self.other_nan),
            ("rpose", self.other_nan * 2),
            ("lpose", self.other_nan * 2),
        ):
            gone = self._burst_nan(rng, T, p)
            cols = lm.GROUP_IDX[g].reshape(-1)
            x[np.ix_(gone, cols)] = np.nan
        out = (x.astype(np.float32), phrase)
        self._cache[idx] = out
        return out
