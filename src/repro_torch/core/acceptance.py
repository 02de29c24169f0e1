"""Online acceptance-rate estimation (Eq. 4), host side; a copy of the reference's.

EMA over a local history window of *first-token* acceptance outcomes:
  a_new = lambda * a_prev + (1 - lambda) * mean(last H outcomes)

Estimates for inactive configurations are preserved (Appendix D); cold-start
uses heuristic priors based on DSIA aggressiveness.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional

EMA_LAM = 0.7
EMA_WINDOW = 20


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
