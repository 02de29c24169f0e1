"""Prompt Lookup Decoding (PLD) — the bottom draft model M_dn; a copy of the
reference's host ``PromptLookup``.

Retrieval-based n-gram drafting: find the longest suffix of the current
context that re-occurs earlier in the context and propose the tokens that
followed its most recent admissible occurrence. The continuation must exist
and must not run into the suffix itself.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class PromptLookup:
    def __init__(self, max_ngram: int = 4, min_ngram: int = 1, max_draft: int = 10):
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_draft = max_draft

    def propose(self, context: np.ndarray, k: Optional[int] = None) -> np.ndarray:
        """Return up to ``k`` draft tokens (possibly empty)."""
        tokens, _ = self.propose_with_confidence(context, k)
        return tokens

    def propose_with_confidence(
        self, context: np.ndarray, k: Optional[int] = None
    ) -> Tuple[np.ndarray, float]:
        """Draft tokens plus a confidence proxy: the matched n-gram length
        over ``max_ngram`` (longer matches rank higher)."""
        k = k or self.max_draft
        ctx = np.asarray(context).ravel()
        n = len(ctx)
        empty = np.zeros((0,), dtype=ctx.dtype)
        if n < self.min_ngram + 1:
            return empty, 0.0
        for ng in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            suffix = ctx[n - ng:]
            windows = np.lib.stride_tricks.sliding_window_view(ctx[: n - 1], ng)
            hits = np.flatnonzero((windows == suffix).all(axis=1))
            hits = hits[hits + 2 * ng < n]
            if len(hits):
                cont_start = int(hits[-1]) + ng
                cont = ctx[cont_start: min(cont_start + k, n - ng)]
                return cont.copy(), ng / self.max_ngram
        return empty, 0.0
