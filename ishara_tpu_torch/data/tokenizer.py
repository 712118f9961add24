"""Tokenizers (copies of ``ishara_tpu/data/tokenizer.py``'s):
:class:`CTCTokenizer` -- ids 0..58 are characters, 59 is pad/blank ``^``;
:class:`Seq2SeqTokenizer` -- pad 0, sos 1, eos 2, characters shifted up by
3."""

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


class Seq2SeqTokenizer:
    """Tokenizer for the encoder-decoder path (copy of ``ishara_tpu/data/
    tokenizer.py``'s): pad=0, sos=1, eos=2, characters at 3 and up."""

    def __init__(self, char_map: dict[str, int] | None = None):
        base = char_map or default_char_map()
        self.pad_token = 0
        self.pad_idx = 0  # alias: datasets use .pad_idx uniformly
        self.sos_token = 1
        self.eos_token = 2
        self.char_to_idx = {c: i + 3 for c, i in base.items()}
        self.idx_to_char = {v: k for k, v in self.char_to_idx.items()}
        self.vocab_size = len(self.char_to_idx) + 3

    def encode(self, text: str, max_len: int | None = None) -> np.ndarray:
        chars = [self.char_to_idx[c] for c in text if c in self.char_to_idx]
        if max_len is not None:
            # truncate the *characters* so sos/eos always survive
            chars = chars[: max_len - 2]
        ids = [self.sos_token] + chars + [self.eos_token]
        if max_len is not None:
            ids += [self.pad_token] * (max_len - len(ids))
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        out = []
        for i in np.asarray(ids).ravel():
            i = int(i)
            if i == self.eos_token:
                break
            if i not in (self.pad_token, self.sos_token):
                out.append(self.idx_to_char.get(i, ""))
        return "".join(out)
