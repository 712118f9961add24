"""Batch-1 inference engine (port of ``ishara_tpu/serve/engine.py``).

Raw landmark frames -> thin -> normalize/resample -> encoder -> greedy CTC
collapse -> short-output fallback, all on the device: the host pads the raw
sequence into a fixed ``[max_raw_frames, 276]`` buffer, and the only sync is
the copy of the ids back. ``fused=True`` runs the encoder blocks through the
hand-written CUDA kernels (:mod:`ishara_tpu_torch.ops.fused_block`),
``fused="int8"`` with the matmul weights stored as int8, ``dma=True`` with
each block stack as one persistent kernel.

The reference's fallback substitutes the constant phrase "2 a-e -aroe"
whenever the decode yields fewer than 3 characters; reproduced here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import landmarks as lm
from ..data.vocab import PAD_TOKEN_IDX
from ..decode.greedy import greedy_decode
from ..device import resolve_device
from ..models.encoder import IsharaEncoder, check_variant
from ..preprocess.pipeline import GroupStats, preprocess

# Reference constant-phrase fallback ids, in the CTC vocab.
FALLBACK_IDS = np.array([17, 0, 32, 12, 36, 0, 12, 32, 49, 46, 36], np.int32)


def _stats_on(stats: GroupStats | None, device) -> GroupStats:
    stats = stats or GroupStats.identity()
    return GroupStats(
        mean={g: torch.as_tensor(v, dtype=torch.float32).to(device)
              for g, v in stats.mean.items()},
        std={g: torch.as_tensor(v, dtype=torch.float32).to(device)
             for g, v in stats.std.items()})


def make_serving_program(model: IsharaEncoder, stats: GroupStats,
                         max_out: int, decode: str = "greedy",
                         fused: bool | str = False, dma: bool = False,
                         compute_dtype=torch.bfloat16):
    """The per-sequence serving program ``(raw [Tmax, 276], length) ->
    (ids [max_out], count)`` on the model's device: preprocess, encoder,
    greedy decode, fallback.

    ``fused=True`` runs the encoder through :class:`~ishara_tpu_torch.
    models.fused.FusedEncoder` with the block weights packed once, here, at
    ``compute_dtype`` (bf16, the reference's deploy default, or f32).
    ``fused="int8"`` quantizes the weights once, here, never per request
    (the reference's ``prepare_serving_variables``), and the kernels scale
    each product after the dot. ``dma=True`` (with either fused mode) runs
    each stack as one persistent kernel that prefetches the next block's
    weights. ``decode="beam"`` is not ported yet and raises
    ``NotImplementedError`` (ROADMAP.md)."""
    cfg = model.cfg
    check_variant(cfg)
    if decode == "beam":
        raise NotImplementedError(
            'decode="beam" is not ported yet (ROADMAP.md Queue 1: CTC beam '
            "decoding)")
    if decode != "greedy":
        raise ValueError(f"decode must be 'greedy' or 'beam', got {decode!r}")
    if fused not in (False, True, "int8"):
        raise ValueError(f"fused must be False, True or 'int8', got {fused!r}")
    device = next(model.parameters()).device
    if fused:
        from ..models.fused import FusedEncoder
        from ..ops.fused_block import quantize_serving_weights

        sd = model.state_dict()
        if fused == "int8":
            sd, compute_dtype = quantize_serving_weights(sd), "int8"
        encoder = FusedEncoder(cfg, sd, compute_dtype=compute_dtype, dma=dma,
                               device=device)
    else:
        def encoder(x):
            return model(x[None])[0]

    nfb = min(len(FALLBACK_IDS), max_out)
    fb = torch.full((max_out,), PAD_TOKEN_IDX, dtype=torch.long)
    fb[:nfb] = torch.as_tensor(FALLBACK_IDS[:nfb], dtype=torch.long)
    fb = fb.to(device)

    @torch.no_grad()
    def program(raw: torch.Tensor, length: torch.Tensor):
        x = preprocess(raw, length, stats, cfg.frame_len, thin=True,
                       dominant_hand=cfg.dominant_hand)
        ids, count = greedy_decode(encoder(x), max_len=max_out)
        # reference fallback: <3 chars -> constant phrase (cropped if a
        # caller configures max_out below the 11-char fallback)
        use_fb = count < 3
        return (torch.where(use_fb, fb, ids),
                torch.where(use_fb, torch.full_like(count, nfb), count))

    return program


class InferenceEngine:
    """Batch-1 serving of a port ``IsharaEncoder``: the full landmarks ->
    ids pipeline on ``device`` (default ``cuda``; raises when no card is
    visible). The model is moved to ``device`` and set to eval mode."""

    def __init__(self, model: IsharaEncoder, stats: GroupStats | None = None,
                 max_raw_frames: int = 384,
                 max_out: int = lm.MAX_PHRASE_LENGTH,
                 decode: str = "greedy", fused: bool | str = False,
                 dma: bool = False, compute_dtype=torch.bfloat16,
                 device=None):
        """See :func:`make_serving_program` for the option semantics."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.stats = _stats_on(stats, self.device)
        self.max_raw_frames = max_raw_frames
        self.max_out = max_out
        self.frame_len = model.cfg.frame_len
        self._program = make_serving_program(
            self.model, self.stats, max_out, decode=decode, fused=fused,
            dma=dma, compute_dtype=compute_dtype)

    def program_fn(self):
        """The per-sequence program ``(raw, length) -> (ids, count)``."""
        return self._program

    def __call__(self, raw_frames: np.ndarray) -> tuple[np.ndarray, int]:
        """raw [T, 276] (any T) -> (ids [max_out], count). Host-side
        pad/crop to the static buffer; everything else on the device."""
        buf = np.zeros((self.max_raw_frames, lm.N_COLS), np.float32)
        n = min(raw_frames.shape[0], self.max_raw_frames)
        buf[:n] = raw_frames[:n]
        raw = torch.from_numpy(buf).to(self.device)
        length = torch.tensor(max(n, 1), dtype=torch.int32).to(self.device)
        ids, count = self._program(raw, length)
        return ids.cpu().numpy().astype(np.int32), int(count)

    def predict_text(self, raw_frames: np.ndarray, tokenizer) -> str:
        ids, count = self(raw_frames)
        return tokenizer.decode(ids[:count])


class BatchedEngine:
    """Fixed-batch serving: the same per-sequence program as
    :class:`InferenceEngine`, run on each of up to ``batch_size`` sequences
    in turn on the device, as the reference's ``lax.map`` does for the fused
    path (the block kernels are batch-1 designs)."""

    def __init__(self, model: IsharaEncoder, batch_size: int = 8,
                 stats: GroupStats | None = None, max_raw_frames: int = 384,
                 max_out: int = lm.MAX_PHRASE_LENGTH,
                 decode: str = "greedy", fused: bool | str = False,
                 compute_dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.max_raw_frames = max_raw_frames
        self.max_out = max_out
        self._program = make_serving_program(
            self.model, _stats_on(stats, self.device), max_out,
            decode=decode, fused=fused, compute_dtype=compute_dtype)

    def __call__(self, sequences: list[np.ndarray]):
        """list of [T_i, 276] arrays (<= batch_size) -> (ids [B, max_out],
        counts [B]) for the first len(sequences) rows."""
        B = self.batch_size
        bufs = np.zeros((B, self.max_raw_frames, lm.N_COLS), np.float32)
        lens = np.ones((B,), np.int32)
        for i, s in enumerate(sequences[:B]):
            n = min(s.shape[0], self.max_raw_frames)
            bufs[i, :n] = s[:n]
            lens[i] = max(n, 1)
        raws = torch.from_numpy(bufs).to(self.device)
        lengths = torch.from_numpy(lens).to(self.device)
        outs = [self._program(raws[i], lengths[i]) for i in range(B)]
        ids = torch.stack([i for i, _ in outs])
        counts = torch.stack([c for _, c in outs])
        return (ids.cpu().numpy().astype(np.int32),
                counts.cpu().numpy().astype(np.int32))
