"""Kernel-versus-composition selection table (port of
``ishara_tpu/ops/selection.py``).

Every kernel-or-composition choice in the model layers reads this table, and
lookup picks the nearest anchor in log-space over (dim, T, batch), as in the
reference. None of the reference's rows is carried over: they were measured
on another device and say nothing about this one. The table holds the one
geometry the port measures on the H100 (``chip_smoke.py``'s train phase; the
times are in ``PERF.md``), the flagship training recipe
``(dim 256, T 176, batch 256)``:

* ``train_attn = "flash"`` and ``ffn_dropout_kernel = True``: the training
  step runs the attention and the feed-forward kernels there;
* ``serve_attn = "einsum"``: the serving paths use the composition (their
  fused form is the block-stack kernel, chosen by the engine, not here);
* ``conv_module_fused = False``: the fused conv-module branch kernel
  (``ishara_tpu/ops/conv_kernel.py``) is not ported yet.

With one anchor every geometry resolves to it. Re-deciding each row from
H100 measurements of kernel against composition is open work (ROADMAP.md
Queue 1 item 15).

``translation_decode_fused(dim, T)`` has its own table, one anchor, the
translation model's reference geometry ``(dim 208, T 176)``: whether the
batch-1 decode loop runs as one launch of the decode kernel
(``ops/decoder_kernel.py``) or as the unfused KV-cached loop. The kernel's
hard limit is shared memory, checked apart by
``ops.decoder_kernel.fused_decode_fits``.
"""

from __future__ import annotations

import math

_ANCHORS: dict[tuple[int, int, int], dict] = {
    (256, 176, 256): {
        "train_attn": "flash",
        "train_attn_nodrop": "flash",
        "serve_attn": "einsum",
        "ffn_dropout_kernel": True,
        "conv_module_fused": False,
    },
}

_DEFAULT_BATCH = 256  # the reference training recipe's batch


def _nearest(dim: int, T: int, batch: int | None = None) -> dict:
    b = _DEFAULT_BATCH if batch is None else max(int(batch), 1)
    best, bestd = None, math.inf
    for (ad, at, ab), row in _ANCHORS.items():
        d = ((math.log(dim / ad)) ** 2 + (math.log(T / at)) ** 2
             + (math.log(b / ab)) ** 2)
        if d < bestd:
            best, bestd = row, d
    return best


def train_attention(dim: int, T: int, dropout_active: bool = True,
                    batch: int | None = None) -> str:
    """"flash" or "einsum" for the training-mode MHSA forward + backward at
    this geometry."""
    row = _nearest(dim, T, batch)
    return row["train_attn" if dropout_active else "train_attn_nodrop"]


def serve_attention(dim: int, T: int) -> str:
    """The eval-mode MHSA forward's path at this geometry."""
    return _nearest(dim, T, 1)["serve_attn"]


def ffn_fused_when_dropout(dim: int, T: int,
                           batch: int | None = None) -> bool:
    """Whether the block FFN sites run the fused kernel when a dropout site
    is active."""
    return _nearest(dim, T, batch)["ffn_dropout_kernel"]


def conv_module_fused(dim: int, T: int, batch: int | None = None) -> bool:
    """Whether the Squeezeformer conv-module branch runs as one kernel."""
    return _nearest(dim, T, batch)["conv_module_fused"]


# Measured on the H100 by chip_smoke.py's translation phase (the numbers
# are in PERF.md): at (208, 176), 63 greedy steps, the decode kernel takes
# about 4 ms against about 140 ms for the unfused KV-cached loop (decode
# only), and at beam width 4 about 8 ms against about 190 ms: True.
_DECODE_ANCHORS: dict[tuple[int, int], dict] = {
    (208, 176): {"decode_fused": True},
}


def translation_decode_fused(dim: int, T: int) -> bool:
    """Whether the batch-1 translation decode runs as one kernel launch at
    this geometry (nearest anchor). Callers also check
    ``ops.decoder_kernel.fused_decode_fits``."""
    best, bestd = None, math.inf
    for (ad, at), row in _DECODE_ANCHORS.items():
        d = (math.log(dim / ad)) ** 2 + (math.log(T / at)) ** 2
        if d < bestd:
            best, bestd = row, d
    return best["decode_fused"]
