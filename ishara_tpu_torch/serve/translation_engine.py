"""Batch-1 serving of the encoder-decoder translation model (port of
``ishara_tpu/serve/translation_engine.py``).

Raw landmarks -> preprocess -> grouped reshape -> encoder (once) ->
autoregressive decode -> token ids + confidence, on the device; the host
pads the raw sequence into a fixed ``[max_raw_frames, 276]`` buffer.
``fused=True`` runs the whole decode loop, greedy or beam, as one launch of
the decode kernel (:mod:`ishara_tpu_torch.ops.decoder_kernel`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..data import landmarks as lm
from ..decode.autoregressive import (
    beam_translate_cached,
    greedy_translate,
    greedy_translate_cached,
)
from ..device import resolve_device
from ..ops import decoder_kernel, selection
from ..preprocess.pipeline import GroupStats, frame_mask, preprocess
from .engine import _stats_on


def _decode_fn(model, frame_len, max_out, kv_cache, decode, beam_width,
               length_penalty, early_exit, fused):
    """The decode of a [1, T, 92, 3] request: (model, x, mask, **kw) ->
    (tokens [1, max_out], confidence [1])."""
    if decode not in ("greedy", "beam"):
        raise ValueError(f"decode must be 'greedy' or 'beam', got {decode!r}")
    if decode == "beam" and not kv_cache:
        raise ValueError("beam decode requires kv_cache=True")
    if fused not in (False, True, "auto"):
        raise ValueError(f"fused must be False, True or 'auto', got "
                         f"{fused!r}")
    W = beam_width if decode == "beam" else 1
    if fused == "auto":
        fused = (selection.translation_decode_fused(model.feature_dim,
                                                    frame_len)
                 and decoder_kernel.fused_decode_fits(model, frame_len,
                                                      max_out, W))
    if fused:
        decoder_kernel.check_decode_fits(model, frame_len, max_out, W)
        pack = decoder_kernel.pack_decoder(model)
    if decode == "beam":
        beam = (functools.partial(decoder_kernel.fused_beam_translate,
                                  pack=pack) if fused
                else beam_translate_cached)

        def decode_fn(model, x, mask, **kw):
            tokens, conf, _ = beam(model, x, mask, beam_width=beam_width,
                                   length_penalty=length_penalty, **kw)
            return tokens, conf
        return decode_fn
    if fused:
        return functools.partial(decoder_kernel.fused_greedy_translate,
                                 pack=pack)
    if kv_cache:
        return functools.partial(greedy_translate_cached,
                                 early_exit=early_exit)
    return greedy_translate


class TranslationEngine:
    """Batch-1 serving of a port ``ASLTranslationModel`` on ``device``
    (default ``cuda``; raises when no card is visible). The model is moved
    to ``device`` and set to eval mode."""

    def __init__(self, model, stats: GroupStats | None = None,
                 frame_len: int = lm.FRAME_LEN, max_raw_frames: int = 384,
                 max_out: int = lm.MAX_PHRASE_LENGTH, sos: int = 1,
                 eos: int = 2, pad: int = 0, kv_cache: bool = True,
                 decode: str = "greedy", beam_width: int = 4,
                 length_penalty: float = 0.0, early_exit: bool = True,
                 fused: bool | str = False, device=None):
        """``kv_cache=True`` decodes with per-layer self-attention K/V
        caches and once-computed cross-attention K/V; ``False`` runs the
        full-prefix oracle. ``decode="beam"`` runs KV-cached beam search
        (requires ``kv_cache=True``). ``fused=True`` runs the whole decode
        loop, greedy or beam, as one launch of the decode kernel, and raises
        (``DecoderFitError``) where the kernel cannot take the geometry;
        ``fused="auto"`` runs it where the selection table
        (``ops/selection.py``) chooses it and it fits, the unfused loop
        elsewhere; the kernel's weights are packed once, here. ``early_exit``
        is the unfused greedy loop's (the kernel always stops at eos); the
        tokens are the same either way."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_raw_frames = max_raw_frames
        self.max_out = max_out
        decode_fn = _decode_fn(self.model, frame_len, max_out, kv_cache,
                               decode, beam_width, length_penalty,
                               early_exit, fused)
        stats = _stats_on(stats, self.device)
        model = self.model

        @torch.no_grad()
        def program(raw: torch.Tensor, length: torch.Tensor):
            flat = preprocess(raw, length, stats, frame_len)
            mask = frame_mask(flat)[None]
            x = flat.reshape(1, frame_len, lm.N_LANDMARKS, 3)
            tokens, confidence = decode_fn(model, x, mask, max_len=max_out,
                                           sos=sos, eos=eos, pad=pad)
            return tokens[0], confidence[0]

        self._program = program

    def program_fn(self):
        """The per-sequence program ``(raw, length) -> (tokens,
        confidence)``."""
        return self._program

    def __call__(self, raw_frames: np.ndarray) -> tuple[np.ndarray, float]:
        """raw [T, 276] (any T) -> (token ids [max_out], confidence)."""
        buf = np.zeros((self.max_raw_frames, lm.N_COLS), np.float32)
        n = min(raw_frames.shape[0], self.max_raw_frames)
        buf[:n] = raw_frames[:n]
        raw = torch.from_numpy(buf).to(self.device)
        length = torch.tensor(max(n, 1), dtype=torch.int32).to(self.device)
        tokens, conf = self._program(raw, length)
        return tokens.cpu().numpy().astype(np.int32), float(conf)

    def predict_text(self, raw_frames: np.ndarray,
                     tokenizer) -> tuple[str, float]:
        tokens, conf = self(raw_frames)
        return tokenizer.decode(tokens), conf


class BatchedTranslationEngine:
    """Fixed-batch throughput serving: the batch's preprocessing under
    ``torch.vmap`` feeding one batched KV-cached greedy decode (the batch
    shares the loop, so the early exit waits for the slowest sequence)."""

    def __init__(self, model, batch_size: int = 8,
                 stats: GroupStats | None = None,
                 frame_len: int = lm.FRAME_LEN, max_raw_frames: int = 384,
                 max_out: int = lm.MAX_PHRASE_LENGTH, sos: int = 1,
                 eos: int = 2, pad: int = 0, early_exit: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.max_raw_frames = max_raw_frames
        self.max_out = max_out
        stats = _stats_on(stats, self.device)
        model = self.model

        @torch.no_grad()
        def program(raws: torch.Tensor, lengths: torch.Tensor):
            flat = torch.vmap(
                lambda r, n: preprocess(r, n, stats, frame_len))(raws,
                                                                 lengths)
            mask = frame_mask(flat)
            x = flat.reshape(batch_size, frame_len, lm.N_LANDMARKS, 3)
            return greedy_translate_cached(model, x, mask, max_len=max_out,
                                           sos=sos, eos=eos, pad=pad,
                                           early_exit=early_exit)

        self._program = program

    def program_fn(self):
        return self._program

    def __call__(self, raws: list[np.ndarray]
                 ) -> tuple[np.ndarray, np.ndarray]:
        """list of B [T_i, 276] arrays -> (tokens [B, max_out], conf [B])."""
        if len(raws) != self.batch_size:
            raise ValueError(
                f"expected {self.batch_size} sequences, got {len(raws)}")
        buf = np.zeros((self.batch_size, self.max_raw_frames, lm.N_COLS),
                       np.float32)
        lens = np.zeros((self.batch_size,), np.int32)
        for i, r in enumerate(raws):
            n = min(r.shape[0], self.max_raw_frames)
            buf[i, :n] = r[:n]
            lens[i] = max(n, 1)
        tokens, conf = self._program(torch.from_numpy(buf).to(self.device),
                                     torch.from_numpy(lens).to(self.device))
        return (tokens.cpu().numpy().astype(np.int32),
                conf.cpu().numpy().astype(np.float32))

    def predict_texts(self, raws: list[np.ndarray], tokenizer) -> list[str]:
        tokens, _ = self(raws)
        return [tokenizer.decode(t) for t in tokens]
