"""Per-configuration cost coefficients (§4.2) and the batched server's
per-slot draft budgets, host side; copies of the reference's
``CostTracker``, ``best_chain_length`` and ``best_tree_expansions``.

``c_hat(config)`` is the ratio of a configuration's measured per-call
latency to the target's single-step latency, an EMA of wall-clock
observations; before any target observation a stored prior (a ratio) is
returned as is.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.ewif import best_dytc_k, t_sd


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


def best_chain_length(alpha: float, c: float, k_max: int, t_min: float = 1.0) -> int:
    """Per-slot chain draft length: the k maximizing T_SD(alpha, c, k), or 0
    (plain AR inside the same verify) when even the best falls below
    ``t_min``."""
    best_k, best_v = 0, 1.0          # k=0 == autoregressive, speedup 1.0
    for k in range(1, max(k_max, 0) + 1):
        v = t_sd(alpha, c, k)
        if v > best_v:
            best_k, best_v = k, v
    return best_k if best_v >= t_min else 0


def best_tree_expansions(alpha: float, c: float, e_max: int, t_min: float = 1.0) -> int:
    """Per-slot tree expansion budget: the argmax of the Eq. 5 objective with
    the drafter as its own continuation, gated on the chain EWIF at that
    budget as ``best_chain_length`` is."""
    _, best_k = best_dytc_k(alpha, c, alpha, c, e_max)
    if best_k <= 0:
        return 0
    return best_k if t_sd(alpha, c, best_k) >= t_min else 0
