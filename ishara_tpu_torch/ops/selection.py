"""Kernel-versus-composition selection table (port of
``ishara_tpu/ops/selection.py``).

Every kernel-or-composition choice in the model layers reads this table, and
lookup picks the nearest anchor in log-space over (dim, T, batch), as in the
reference. None of the reference's rows is carried over: they were measured
on another device and say nothing about this one. The table holds the two
geometries the port drives on the H100 (``chip_smoke.py``'s train phases;
the times are in ``PERF.md``):

* the flagship training recipe ``(dim 256, T 176, batch 256)``:
  ``train_attn = "flash"`` (and without dropout too),
  ``ffn_dropout_kernel = True`` and ``conv_module_fused = True``, so the
  step runs the attention, the feed-forward and the conv-module kernels;
* the long-sequence step ``(dim 256, T 512, batch 256)``:
  ``train_attn_nodrop = "flash_blocked"`` (the tiled attention kernel,
  :mod:`.attention_blocked`, the only training kernel beyond ``T = 384``)
  and ``conv_module_fused = True`` (the conv-module branch as one kernel,
  :mod:`.conv_kernel`). Its dropout-on attention rows equal the
  flagship's; beyond ``T = 384`` the layer sends ``"flash"`` to the
  composition, as the reference does, so the attention of training with
  dropout changes at no geometry. The conv-module branch has no dropout,
  and both rows take its kernel.

In both rows ``serve_attn = "einsum"``: the serving paths use the
composition (their fused form is the block-stack kernel, chosen by the
engine, not here). With two anchors at batch 256 the long row captures the
geometries whose ``T`` lies above ``sqrt(176 * 512) ~ 300`` (at equal dim
and batch); the flagship step ``(256, 176, 256)`` and batch-1 serving at
``T = 176`` resolve to the flagship row.

The attention rows were decided from ``chip_smoke.py``'s selection timings
on an NVIDIA H100 80GB HBM3 at 700 W (batch 256, 8 heads of 32, bf16,
forward + backward ms; the composition is the layer's einsum path with the
dropout kernel on the weights):

* ``(256, 176, 256)``: dropout 0.4: ``"flash"`` 0.9882 against the
  composition's 2.1569; no dropout: ``"flash"`` 0.5267, ``"flash_blocked"``
  0.5480, the composition 1.9718;
* ``(256, 512, 256)``: no dropout: ``"flash_blocked"`` 2.7298 against
  12.7260; with dropout the row decides only ``T <= 384`` (beyond it the
  layer takes the composition): at T 384 ``"flash"`` 3.4453 against
  8.3464.

The conv-module and feed-forward rows were decided from the same script's
times (``conv_module_kernel_rows``, ``ffn_selection_times``; NVIDIA H100
80GB HBM3, 700 W, batch 256, dim 256, bf16, forward + backward ms):

* ``conv_module_fused``: the kernel (time tiles with a halo) 3.4413 against
  the composition's 3.9721 at T 176 -- True, flipped from False; 8.8953
  against 9.6932 at T 512 -- True;
* ``ffn_dropout_kernel`` (hidden 512, rates 0.4 / 0.4): the kernel 0.8889
  against the composition's 0.5671 at T 176 and 2.3298 against 1.3423 at
  T 512. The kernel still loses; both rows keep it until its re-port is
  done (ROADMAP.md Queue 2: a row keeps the kernel until then).

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
        "conv_module_fused": True,
    },
    (256, 512, 256): {
        "train_attn": "flash",
        "train_attn_nodrop": "flash_blocked",
        "serve_attn": "einsum",
        "ffn_dropout_kernel": True,
        "conv_module_fused": True,
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
    """"flash", "flash_blocked" or "einsum" for the training-mode MHSA
    forward + backward at this geometry. The tiled kernel has no dropout
    inside, so with dropout active a "flash_blocked" row gives way to the
    row's dropout choice, as in the reference."""
    row = _nearest(dim, T, batch)
    path = row["train_attn" if dropout_active else "train_attn_nodrop"]
    if dropout_active and path == "flash_blocked":
        path = "flash" if row["train_attn"] == "flash" else "einsum"
    return path


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


# Measured on the H100 (80GB HBM3, 700 W) by chip_smoke.py's translation
# phase, kernel and loop in the same run (PERF.md): at (208, 176), 63
# greedy steps, the decode kernel takes 2.82 ms against 135.27 ms for the
# unfused KV-cached loop (decode only), and at beam width 4 5.38 ms
# against 191.64 ms: True.
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
