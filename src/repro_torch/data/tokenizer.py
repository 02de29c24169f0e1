"""Byte-level tokenizer (no vocabulary files); a copy of the reference's."""
from __future__ import annotations

from typing import Iterable

import numpy as np


class ByteTokenizer:
    """UTF-8 bytes + <pad>=256, <bos>=257, <eos>=258. vocab_size=259 padded
    up to a multiple of 64."""

    PAD, BOS, EOS = 256, 257, 258

    def __init__(self, pad_to_multiple: int = 64):
        v = 259
        self.vocab_size = ((v + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return np.asarray(ids, np.int32)

    def decode(self, ids: Iterable[int]) -> str:
        bs = bytes(i for i in ids if 0 <= i < 256)
        return bs.decode("utf-8", errors="replace")
