"""Landmark preprocessing on tensors (port of ``ishara_tpu/preprocess/
pipeline.py``).

Statically shaped like the reference: the raw sequence arrives padded on the
host to ``[Tmax, 276]`` and its valid length travels as a 0-d tensor, so the
whole dominant-hand -> thin -> resample/pad -> permute -> normalize chain runs
on the device without a host sync (no ``.item()``, no boolean-mask gathers).

Layout: raw input is ``[T, 276]`` (x/y/z blocks of 92 landmarks, see
:mod:`ishara_tpu_torch.data.landmarks`); model input is ``[frame_len, 276]``
ordered lip(40) | rhand(21) | lhand(21) | rpose(5) | lpose(5), each as x,y,z
triples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data import landmarks as lm


class GroupStats(NamedTuple):
    """Per-group normalization statistics, broadcastable against [T, n, 3]."""

    mean: dict[str, torch.Tensor]
    std: dict[str, torch.Tensor]

    @staticmethod
    def identity() -> "GroupStats":
        return GroupStats(
            mean={g: torch.zeros((1, 1, 3)) for g in lm.GROUPS},
            std={g: torch.ones((1, 1, 3)) for g in lm.GROUPS},
        )


_COL_CACHE: dict[tuple[str, str], torch.Tensor] = {}


def _cols(name: str, device) -> torch.Tensor:
    """A constant column-index table on ``device``, copied there once (a
    fresh host-to-device copy on every request would stall the stream)."""
    key = (name, str(device))
    if key not in _COL_CACHE:
        _COL_CACHE[key] = torch.as_tensor(_TABLES[name], dtype=torch.long,
                                          device=device)
    return _COL_CACHE[key]


def resample_or_pad(x: torch.Tensor, length: torch.Tensor,
                    frame_len: int) -> torch.Tensor:
    """``x`` [Tmax, ...] with valid rows [0, length) -> [frame_len, ...].

    Shorter sequences are NaN-padded at the end; longer ones are resampled
    along time with half-pixel-centre bilinear weights (``tf.image.resize``).
    Both branches are computed and one is selected, as in the reference."""
    length = torch.as_tensor(length, device=x.device).to(torch.float32)
    i = torch.arange(frame_len, dtype=torch.float32, device=x.device)
    bshape = (frame_len,) + (1,) * (x.dim() - 1)

    src = (i + 0.5) * (length / frame_len) - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0),
                        torch.clamp(length - 1.0, min=0.0))
    lo = torch.floor(src)
    w = (src - lo).reshape(bshape)
    lo_i = lo.to(torch.long)
    hi_i = torch.minimum(lo_i + 1,
                         torch.clamp(length.to(torch.long) - 1, min=0))
    resized = x[lo_i] * (1.0 - w) + x[hi_i] * w

    idx = torch.clamp(torch.arange(frame_len, device=x.device),
                      max=x.shape[0] - 1)
    row_valid = (i < length).reshape(bshape)
    padded = torch.where(row_valid, x[idx], float("nan"))
    return torch.where(length <= frame_len, padded, resized)


def _mirror_perm() -> np.ndarray:
    """Swap right<->left hand blocks and RPOSE<->LPOSE blocks within each
    coordinate; lip columns stay (reference flip swaps only those blocks)."""
    n = lm.N_LANDMARKS
    perm = np.arange(n)
    perm[0:21], perm[21:42] = np.arange(21, 42), np.arange(0, 21)
    perm[42:47], perm[47:52] = np.arange(47, 52), np.arange(42, 47)
    return np.concatenate([perm, perm + n, perm + 2 * n])


def mirror_lr(x: torch.Tensor) -> torch.Tensor:
    """Mirror a [T, 276] sequence left<->right: swap hand/pose blocks and
    reflect x-coordinates about 0.5. An involution."""
    flipped = x[:, _cols("mirror", x.device)]
    n = lm.N_LANDMARKS
    return torch.cat([1.0 - flipped[:, :n], flipped[:, n:]], dim=1)


def dominant_hand_mirror(x: torch.Tensor, length: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mirror the sequence when the LEFT hand has fewer NaNs than the right
    over the valid frames. Returns (x, left_was_dominant)."""
    valid = (torch.arange(x.shape[0], device=x.device) < length)[:, None]
    r_nan = (torch.isnan(x[:, _cols("rhand", x.device)])
             & valid).sum()
    l_nan = (torch.isnan(x[:, _cols("lhand", x.device)])
             & valid).sum()
    left_dominant = l_nan < r_nan
    return torch.where(left_dominant, mirror_lr(x), x), left_dominant


def thin_frames(x: torch.Tensor, length: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference-time frame thinning (reference ``pre_process00``): keep
    frames with hand signal or at an even position, compacted to the front
    by a cumsum-rank gather. Returns (compacted [Tmax, 276], new length);
    rows at or past the new length are unspecified."""
    T = x.shape[0]
    dev = x.device
    valid = torch.arange(T, device=dev) < length
    hands = torch.nan_to_num(x[:, _cols("hands", dev)], nan=0.0)
    signal = hands.sum(dim=1) != 0.0
    alternating = (torch.arange(T, device=dev) % 2) == 0
    keep = (signal | alternating) & valid

    csum = torch.cumsum(keep.to(torch.int32), dim=0)
    targets = torch.arange(1, T + 1, dtype=torch.int32, device=dev)[:, None]
    idx = (csum[None, :] < targets).to(torch.int32).sum(dim=1)
    return x[torch.clamp(idx, max=T - 1).to(torch.long)], csum[-1]


# Constant gather tables. "out" is the flat output-column permutation:
# output column j reads input column out[j] (lip|rhand|lhand|rpose|lpose,
# x,y,z triples).
_TABLES = {
    "mirror": _mirror_perm(),
    "rhand": lm.GROUP_IDX["rhand"].ravel(),
    "lhand": lm.GROUP_IDX["lhand"].ravel(),
    "hands": np.concatenate([lm.GROUP_IDX["rhand"].ravel(),
                             lm.GROUP_IDX["lhand"].ravel()]),
    "out": np.concatenate([lm.GROUP_IDX[g].ravel() for g in lm.CONCAT_ORDER]),
}


def _flat_stats(stats: GroupStats, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group [1, 1, 3] (or [1, n, 3]) stats -> flat [276] vectors in
    output-column order."""
    means, stds = [], []
    for g in lm.CONCAT_ORDER:
        n = lm.GROUP_IDX[g].shape[0]
        means.append(torch.as_tensor(stats.mean[g], dtype=torch.float32)
                     .broadcast_to((1, n, 3)).reshape(-1))
        stds.append(torch.as_tensor(stats.std[g], dtype=torch.float32)
                    .broadcast_to((1, n, 3)).reshape(-1))
    return torch.cat(means).to(device), torch.cat(stds).to(device)


def preprocess(x: torch.Tensor, length: torch.Tensor, stats: GroupStats,
               frame_len: int = lm.FRAME_LEN, thin: bool = False,
               dominant_hand: bool = False) -> torch.Tensor:
    """[Tmax, 276] raw + valid length -> [frame_len, 276] model input.

    ``thin=True`` is the inference-path frame thinning; ``dominant_hand``
    mirrors left-dominant sequences first. Computed flat, as the reference
    does: one time-resample, one column gather, one scale/shift, NaN -> 0."""
    length = torch.as_tensor(length, device=x.device)
    if dominant_hand:
        x, _ = dominant_hand_mirror(x, length)
    if thin:
        x, length = thin_frames(x, length)
    mean, std = _flat_stats(stats, x.device)
    out = resample_or_pad(x, length, frame_len)[:, _cols("out", x.device)]
    out = (out - mean) / std
    return torch.nan_to_num(out, nan=0.0)


def frame_mask(x: torch.Tensor) -> torch.Tensor:
    """Keras ``Masking(0.0)``: a frame is valid if any feature != 0.
    Returns [..., T] boolean."""
    return (x != 0.0).any(dim=-1)
