"""CTC character tokenizer (copy of ``ishara_tpu/data/tokenizer.py``'s
``CTCTokenizer``): ids 0..58 are characters, 59 is pad/blank ``^``."""

from __future__ import annotations

import numpy as np

from .vocab import PAD_TOKEN, PAD_TOKEN_IDX, default_char_map


class CTCTokenizer:
    """Character tokenizer for the CTC path: ids 0..58 chars, 59 = pad/blank."""

    def __init__(self, char_map: dict[str, int] | None = None):
        self.char_to_idx = dict(char_map or default_char_map())
        self.char_to_idx.setdefault(PAD_TOKEN, PAD_TOKEN_IDX)
        self.idx_to_char = {v: k for k, v in self.char_to_idx.items()}
        self.pad_idx = self.char_to_idx[PAD_TOKEN]
        self.vocab_size = len(self.char_to_idx)

    def encode(self, text: str, max_len: int | None = None) -> np.ndarray:
        ids = [self.char_to_idx[c] for c in text if c in self.char_to_idx]
        if max_len is not None:
            ids = ids[:max_len] + [self.pad_idx] * max(0, max_len - len(ids))
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        return "".join(
            self.idx_to_char.get(int(i), "") for i in np.asarray(ids).ravel()
            if int(i) != self.pad_idx
        )
