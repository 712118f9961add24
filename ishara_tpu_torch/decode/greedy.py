"""Greedy CTC decoding with fixed shapes (port of
``ishara_tpu/decode/greedy.py``): no host sync, so it runs inside the serving
program and the evaluation step on the device."""

from __future__ import annotations

import torch

from ..data.landmarks import MAX_PHRASE_LENGTH
from ..data.vocab import PAD_TOKEN_IDX


def greedy_decode_batch(logits: torch.Tensor, blank_id: int = PAD_TOKEN_IDX,
                        max_len: int = MAX_PHRASE_LENGTH,
                        lengths: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, C] logits -> (ids [B, max_len] padded with blank, counts [B]).

    The reference collapse: keep frame i where x[i] != x[i+1] (the last
    frame of each run) and x[i] is not blank. The final run is never kept,
    since the last frame has no successor (reference quirk). Argmax ties go
    to the first index; ``counts`` is capped at ``max_len``."""
    T = logits.shape[1]
    dev = logits.device
    x = torch.argmax(logits, dim=-1)
    nxt = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    if lengths is not None:
        t = torch.arange(T, device=dev)[None, :]
        n = torch.as_tensor(lengths, device=dev).reshape(-1, 1)
        x = torch.where(t < n, x, blank_id)
        nxt = torch.where(t >= n - 1, x, nxt)
    keep = (x != nxt) & (x != blank_id)

    dropped = ~keep
    order = torch.argsort(dropped.to(torch.uint8), dim=1, stable=True)
    ids = torch.where(dropped.gather(1, order), blank_id, x.gather(1, order))
    counts = torch.clamp(keep.sum(dim=1), max=max_len)
    if T >= max_len:
        ids = ids[:, :max_len]
    else:
        ids = torch.nn.functional.pad(ids, (0, max_len - T), value=blank_id)
    return ids, counts


def greedy_decode(logits: torch.Tensor, blank_id: int = PAD_TOKEN_IDX,
                  max_len: int = MAX_PHRASE_LENGTH,
                  length: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, C] logits -> (ids [max_len] padded with blank, count): one row of
    :func:`greedy_decode_batch`."""
    ids, counts = greedy_decode_batch(
        logits[None], blank_id, max_len,
        None if length is None else torch.as_tensor(length).reshape(1))
    return ids[0], counts[0]
