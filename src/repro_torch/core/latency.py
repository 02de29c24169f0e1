"""Per-configuration cost coefficients (§4.2), host side; a copy of the
reference's ``CostTracker``.

``c_hat(config)`` is the ratio of a configuration's measured per-call
latency to the target's single-step latency, an EMA of wall-clock
observations; before any target observation a stored prior (a ratio) is
returned as is.
"""
from __future__ import annotations

from typing import Optional


class CostTracker:
    def __init__(self, ema: float = 0.8):
        self.ema = ema
        self._lat: dict = {}
        self._target_lat: Optional[float] = None

    def observe(self, config: str, seconds: float, tokens: int = 1) -> None:
        per_tok = seconds / max(tokens, 1)
        prev = self._lat.get(config)
        self._lat[config] = per_tok if prev is None else self.ema * prev + (1 - self.ema) * per_tok

    def observe_target(self, seconds: float, tokens: int = 1) -> None:
        per_tok = seconds / max(tokens, 1)
        prev = self._target_lat
        self._target_lat = per_tok if prev is None else self.ema * prev + (1 - self.ema) * per_tok

    def set_prior(self, config: str, c: float) -> None:
        self._lat.setdefault(config, c)  # stored as ratio until target known

    def c_hat(self, config: str, default: float = 0.5) -> float:
        lat = self._lat.get(config)
        if lat is None:
            return default
        if self._target_lat is None or self._target_lat <= 0:
            return lat if lat < 10 else default   # prior stored as ratio
        return min(lat / self._target_lat, 10.0)
