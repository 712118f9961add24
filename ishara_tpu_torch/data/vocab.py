"""Character vocabulary for ASLFR fingerspelling.

A copy of the module of the same name in ``ishara_tpu/data/``: the port
imports nothing of the JAX package.

Two token schemes exist in the reference and both are supported here:

* CTC scheme (``Test Notebooks/conv-squeezeformer-conformer-test.ipynb`` cell 1):
  59 printable characters at ids 0..58 plus the pad/blank token ``^`` at 59.
* seq2seq scheme (``integration.py:473-501`` / ``asl-translation-nb4.ipynb``):
  pad / sos / eos control tokens appended after the character set.

The 59-character set is the public ASLFR competition
``character_to_prediction_index.json``; `load_char_map` accepts an external
JSON to override it.
"""

from __future__ import annotations

import json
from pathlib import Path

# The public ASLFR character set, in prediction-index order (ids 0..58).
ASLFR_CHARS = " !#$%&'()*+,-./0123456789:;=?@[_abcdefghijklmnopqrstuvwxyz~"
assert len(ASLFR_CHARS) == 59

PAD_TOKEN = "^"
PAD_TOKEN_IDX = 59
NUM_CLASSES = 60  # 59 chars + pad/blank


def default_char_map() -> dict[str, int]:
    """char -> prediction index, without the pad token."""
    return {c: i for i, c in enumerate(ASLFR_CHARS)}


def load_char_map(path: str | Path | None = None) -> dict[str, int]:
    """Load ``character_to_prediction_index.json``; fall back to the built-in set."""
    if path is None:
        return default_char_map()
    with open(path) as f:
        return json.load(f)
