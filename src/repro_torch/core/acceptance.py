"""Online acceptance-rate estimation (Eq. 4), host side; a copy of the reference's.

EMA over a local history window of *first-token* acceptance outcomes:
  a_new = lambda * a_prev + (1 - lambda) * mean(last H outcomes)

Estimates for inactive configurations are preserved (Appendix D); cold-start
uses heuristic priors based on DSIA aggressiveness.

Two forms with the same semantics, as in the reference: ``AcceptanceTracker``
(host, per-config string keys: the split serving rounds and the B=1 engine)
and ``ema_init``/``ema_update`` (per-slot tensors carried through the
single-dispatch serving round, so that round r+1's budgets are computed on
the device inside round r).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional

import torch

EMA_LAM = 0.7
EMA_WINDOW = 20


def ema_init(batch: int, window: int = EMA_WINDOW, prior: float = 0.5, *, device="cpu"):
    """Tensor form of a fresh per-slot ``AcceptanceTracker``: returns
    ``(alpha (B,) float32, hist (B, W) float32, hist_n (B,) int32,
    hist_ptr (B,) int32)``."""
    return (torch.full((batch,), prior, dtype=torch.float32, device=device),
            torch.zeros((batch, window), dtype=torch.float32, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device))


def ema_update(alpha, hist, hist_n, hist_ptr, outcome, valid, lam: float = EMA_LAM):
    """One ``AcceptanceTracker.observe`` per slot where ``valid`` (B,) bool
    holds, with ``outcome`` (B,) in {0, 1}; other slots pass through. The
    ring buffer ``hist`` keeps the last W outcomes, so its masked mean is
    the host deque's mean. Returns new tensors; no host read."""
    B, W = hist.shape
    b_idx = torch.arange(B, device=hist.device)
    ptr = hist_ptr.long()
    # one write per row, distinct rows: a slot that observes nothing writes
    # its own old value back
    hist = hist.index_put((b_idx, ptr), torch.where(valid, outcome.float(), hist[b_idx, ptr]))
    hist_n = torch.where(valid, torch.clamp(hist_n + 1, max=W), hist_n)
    hist_ptr = torch.where(valid, torch.remainder(hist_ptr + 1, W), hist_ptr)
    live_rows = torch.arange(W, device=hist.device)[None, :] < hist_n[:, None]
    recent = (hist * live_rows).sum(dim=1) / torch.clamp(hist_n, min=1)
    alpha = torch.where(valid, lam * alpha + (1.0 - lam) * recent, alpha)
    return alpha, hist, hist_n, hist_ptr


class AcceptanceTracker:
    def __init__(self, lam: float = EMA_LAM, window: int = EMA_WINDOW, prior: float = 0.5):
        self.lam = lam
        self.window = window
        self.prior = prior
        self._alpha: Dict[str, float] = {}
        self._hist: Dict[str, Deque[float]] = {}

    def set_prior(self, config: str, alpha0: float) -> None:
        self._alpha.setdefault(config, float(alpha0))

    def observe(self, config: str, first_token_accepted: bool) -> None:
        h = self._hist.setdefault(config, deque(maxlen=self.window))
        h.append(1.0 if first_token_accepted else 0.0)
        recent = sum(h) / len(h)
        prev = self._alpha.get(config, self.prior)
        self._alpha[config] = self.lam * prev + (1.0 - self.lam) * recent

    def alpha(self, config: str, default: Optional[float] = None) -> float:
        """Current estimate; ``default`` overrides the global cold-start prior."""
        return self._alpha.get(config, self.prior if default is None else default)

    def reset(self, config: str, alpha0: Optional[float] = None) -> None:
        """Drop a configuration's history (a server slot reused by a new
        request); optionally re-seed its cold-start prior."""
        self._alpha.pop(config, None)
        self._hist.pop(config, None)
        if alpha0 is not None:
            self.set_prior(config, alpha0)

    def counts(self, config: str) -> int:
        return len(self._hist.get(config, ()))

    def snapshot(self) -> Dict[str, float]:
        return dict(self._alpha)
