"""Prompt Lookup Decoding (PLD) — the bottom draft model M_dn; a copy of the
reference's host ``PromptLookup``.

Retrieval-based n-gram drafting: find the longest suffix of the current
context that re-occurs earlier in the context and propose the tokens that
followed its most recent admissible occurrence. The continuation must exist
and must not run into the suffix itself.

Two forms with the same results: ``PromptLookup`` (host numpy, one context
at a time; the split rounds and the B=1 engine) and ``propose_device``
(a batched window-compare over a (B, L) context tensor, no host read; the
single-dispatch serving round).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


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


def propose_device(ctx: torch.Tensor, length: torch.Tensor, k: int, *, max_ngram: int = 4,
                   min_ngram: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``PromptLookup.propose`` for every row of a context buffer at once.

    ``ctx[b, :length[b]]`` is slot b's context (committed tokens and the
    pending token); later positions are ignored. Returns ``(chains (B, k)
    int32, have (B,) int32)``: the proposal, zero past ``have``. One
    window-compare per n-gram size, longest first."""
    B, L = ctx.shape
    dev = ctx.device
    s_idx = torch.arange(L, device=dev)
    n = length.to(torch.int64)
    chains = torch.zeros((B, k), dtype=torch.int32, device=dev)
    have = torch.zeros((B,), dtype=torch.int32, device=dev)
    found = torch.zeros((B,), dtype=torch.bool, device=dev)
    for ng in range(max_ngram, min_ngram - 1, -1):
        # eq[b, s] <=> ctx[b, s:s+ng] equals the last ng tokens of slot b
        eq = torch.ones((B, L), dtype=torch.bool, device=dev)
        for i in range(ng):
            win = ctx[:, torch.clamp(s_idx + i, max=L - 1)]
            suf = torch.gather(ctx, 1, torch.clamp(n - ng + i, 0, L - 1)[:, None])
            eq &= win == suf
        # admissible: the continuation exists and starts before the suffix,
        # and the suffix itself fits (n >= ng + 1)
        valid = (s_idx[None, :] + 2 * ng < n[:, None]) & (n[:, None] >= ng + 1)
        best_s = torch.where(eq & valid, s_idx[None, :], -1).amax(dim=1)
        hit = best_s >= 0
        cont0 = best_s + ng
        idx = torch.clamp(cont0[:, None] + torch.arange(k, device=dev)[None, :], 0, L - 1)
        toks = torch.gather(ctx, 1, idx).to(torch.int32)
        use = hit & ~found                  # the longest n-gram wins
        chains = torch.where(use[:, None], toks, chains)
        have = torch.where(use, torch.clamp(n - ng - cont0, 0, k).to(torch.int32), have)
        found |= hit
    chains = torch.where(torch.arange(k, device=dev)[None, :] < have[:, None], chains, 0)
    return chains, have
