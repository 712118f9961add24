"""Greedy CTC decoding with fixed shapes (port of
``ishara_tpu/decode/greedy.py``): no host sync, so it runs inside the serving
program on the device."""

from __future__ import annotations

import torch

from ..data.landmarks import MAX_PHRASE_LENGTH
from ..data.vocab import PAD_TOKEN_IDX


def greedy_decode(logits: torch.Tensor, blank_id: int = PAD_TOKEN_IDX,
                  max_len: int = MAX_PHRASE_LENGTH,
                  length: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, C] logits -> (ids [max_len] padded with blank, count).

    The reference collapse: keep frame i where x[i] != x[i+1] (the last
    frame of each run) and x[i] is not blank. The final run is never kept,
    since the last frame has no successor (reference quirk). Argmax ties go
    to the first index; ``count`` is capped at ``max_len``."""
    T = logits.shape[0]
    dev = logits.device
    x = torch.argmax(logits, dim=-1)
    nxt = torch.cat([x[1:], x[-1:]])
    if length is not None:
        t = torch.arange(T, device=dev)
        x = torch.where(t < length, x, blank_id)
        nxt = torch.where(t >= length - 1, x, nxt)
    keep = (x != nxt) & (x != blank_id)

    dropped = ~keep
    order = torch.argsort(dropped.to(torch.uint8), stable=True)
    ids = torch.where(dropped[order], blank_id, x[order])
    count = torch.clamp(keep.sum(), max=max_len)
    if T >= max_len:
        ids = ids[:max_len]
    else:
        ids = torch.nn.functional.pad(ids, (0, max_len - T), value=blank_id)
    return ids, count
