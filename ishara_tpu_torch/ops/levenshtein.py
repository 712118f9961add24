"""Batched edit distance on the device (port of ``ishara_tpu/ops/
levenshtein.py``).

The confidence target of a translation training step is the normalized
Levenshtein similarity between the greedy prediction and the target; it is
computed here on the step's device with fixed shapes, no host sync. The
dynamic programme runs a row at a time (a loop over ``a``'s positions,
batched over the batch); within a row the left dependency
``cur[j - 1] + 1`` is resolved with a min-plus prefix scan, ``cur[j] =
min_{k <= j} (m[k] - k) + j``, which is ``torch.cummin`` over ``m - j``.
Plain tensor code: the reference computes this outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def batched_edit_distance(a: torch.Tensor, b: torch.Tensor,
                          len_a: torch.Tensor,
                          len_b: torch.Tensor) -> torch.Tensor:
    """Levenshtein distance between ``a[i, :len_a[i]]`` and ``b[i,
    :len_b[i]]`` for every row ``i``: ``a`` [B, N] and ``b`` [B, M] integer
    ids, ``len_a`` / ``len_b`` [B]. Rows of ``a`` past ``len_a`` leave the
    programme as it was; ``len_b`` is clipped to [0, M]. Returns int32
    [B]."""
    B, N = a.shape
    M = b.shape[1]
    j = torch.arange(M + 1, device=b.device, dtype=torch.int64)
    prev = j.expand(B, M + 1)
    len_a = len_a.to(torch.int64)
    for i in range(N):
        cost = (a[:, i:i + 1] != b).to(torch.int64)
        # candidates that do not depend on cur[j - 1]: delete (prev[j] + 1)
        # and substitute (prev[j - 1] + cost); the boundary dp[i + 1][0]
        m = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        full = torch.cat([torch.full((B, 1), i + 1, dtype=torch.int64,
                                     device=b.device), m], dim=1)
        cur = torch.cummin(full - j, dim=1).values + j
        prev = torch.where((i < len_a)[:, None], cur, prev)
    at = torch.clamp(len_b.to(torch.int64), 0, M)[:, None]
    return prev.gather(1, at)[:, 0].to(torch.int32)


def edit_distance(a: torch.Tensor, b: torch.Tensor, len_a,
                  len_b) -> torch.Tensor:
    """Levenshtein distance between ``a[:len_a]`` and ``b[:len_b]`` (``a``
    [N], ``b`` [M] integer ids): an int32 scalar tensor."""
    la = torch.as_tensor(len_a, device=a.device).reshape(1)
    lb = torch.as_tensor(len_b, device=b.device).reshape(1)
    return batched_edit_distance(a[None], b[None], la, lb)[0]


def normalized_similarity(a, b, len_a, len_b) -> torch.Tensor:
    """``1 - dist / max(len_b, 1)`` in float32 [B]: the confidence target."""
    d = batched_edit_distance(a, b, len_a, len_b)
    return 1.0 - d.to(torch.float32) \
        / torch.clamp(len_b, min=1).to(torch.float32)
