"""Per-configuration cost coefficients (§4.2) and the batched server's
per-slot draft budgets, host side; copies of the reference's
``CostTracker``, ``best_chain_length``, ``best_tree_expansions`` and
``best_cascade_plan``, and
their ``*_batched`` tensor twins for the single-dispatch serving round.

``c_hat(config)`` is the ratio of a configuration's measured per-call
latency to the target's single-step latency, an EMA of wall-clock
observations; before any target observation a stored prior (a ratio) is
returned as is.

The hardware-aware latency predictor of §4.2 is here too: the paper fits
Bayesian linear regression (``BayesianLinearLatency``, a numpy copy of the
reference's) on GPU timings. Its features are roofline terms
(``roofline_features``: [1, compute, memory, collective] seconds) on the
H100's constants (``analysis.roofline``), where the reference's are TPU
v5e's. No engine path calls them, as in the reference; ``chip_smoke.py``
phase 16 fits one on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.roofline import RooflineReport
from repro_torch.core.ewif import best_cascade_k, best_dytc_k, dytc_objective_grid, t_sd, t_sd_grid


class BayesianLinearLatency:
    """Gaussian BLR: posterior over w in t = w . phi(x) + noise."""

    def __init__(self, dim: int = 4, prior_scale: float = 10.0, noise: float = 1e-3):
        self.dim = dim
        self.noise = noise
        self.precision = np.eye(dim) / (prior_scale ** 2)
        self.mean_times_prec = np.zeros(dim)

    def observe(self, features: Sequence[float], latency: float) -> None:
        x = np.asarray(features, dtype=np.float64)
        self.precision += np.outer(x, x) / self.noise
        self.mean_times_prec += x * latency / self.noise

    @property
    def weights(self) -> np.ndarray:
        return np.linalg.solve(self.precision, self.mean_times_prec)

    def predict(self, features: Sequence[float]) -> float:
        x = np.asarray(features, dtype=np.float64)
        return float(self.weights @ x)

    def predict_with_var(self, features: Sequence[float]) -> tuple:
        x = np.asarray(features, dtype=np.float64)
        cov = np.linalg.inv(self.precision)
        return float(self.weights @ x), float(x @ cov @ x + self.noise)


def roofline_features(flops: float, bytes_hbm: float, coll_bytes: float,
                      dtype="bfloat16") -> list:
    """phi(x) = [1, compute term, memory term, collective term] (seconds on
    one H100, the compute term at ``dtype``'s peak)."""
    r = RooflineReport("", flops, bytes_hbm, {"all": coll_bytes}, dtype=dtype)
    return [1.0, r.t_compute, r.t_memory, r.t_collective]


def roofline_latency(flops: float, bytes_hbm: float, coll_bytes: float = 0.0,
                     dtype="bfloat16") -> float:
    """Max-of-terms roofline estimate in seconds (the BLR prior's anchor)."""
    return RooflineReport("", flops, bytes_hbm, {"all": coll_bytes}, dtype=dtype).t_bound


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


def best_cascade_plan(alphas: Sequence[float], cs: Sequence[float], alpha_direct: float,
                      e_max: int, t_min: float = 1.0) -> tuple:
    """Per-slot routing and budget of a ``cascade_fused`` round: returns
    ``(expansions, use_rescore)`` for the best of three executions:

      - **cascade** — the cheapest level drafts ``k`` tokens, every stronger
        level rescores in one block forward, the target verifies:
        ``ewif.t_cascade(alphas, cs, k)`` maximized over k;
      - **single-level** — the cheapest level drafts straight for the
        target, priced with ``alpha_direct`` (the slot's tracked
        cheap-vs-target acceptance, or the compositional prior);
      - **PLD-only** — ``(0, False)``: no neural work, speedup 1.0.

    A slot whose best option misses ``t_min`` collapses to PLD-only."""
    v_casc, k_casc = best_cascade_k(alphas, cs, e_max)
    if len(alphas) < 2:
        v_casc = -1.0                       # no level to rescore with
    v_single, k_single = 1.0, 0
    for k in range(1, max(e_max, 0) + 1):
        v = t_sd(alpha_direct, max(cs[-1], 1e-3), k)
        if v > v_single:
            v_single, k_single = v, k
    best = max(v_casc, v_single)
    if best < t_min:
        return 0, False
    if v_casc >= v_single:
        return k_casc, True
    return k_single, False


def best_chain_length_batched(alpha: torch.Tensor, c, k_max: int, t_min: float) -> torch.Tensor:
    """``best_chain_length`` over per-slot ``alpha`` (B,): the argmax of the
    T_SD grid, ties to the first maximum (the host loop replaces only on a
    strictly greater value), 0 below ``t_min``. Returns (B,) int32."""
    vals = t_sd_grid(alpha, c, k_max)
    best_k = torch.argmax(vals, dim=1).to(torch.int32)
    return torch.where(vals.amax(dim=1) >= t_min, best_k, 0)


def best_tree_expansions_batched(alpha: torch.Tensor, c, e_max: int, t_min: float) -> torch.Tensor:
    """``best_tree_expansions`` over per-slot ``alpha`` (B,): the argmax of
    the Eq. 5 grid (first maximum), gated on the chain EWIF at that budget.
    Returns (B,) int32."""
    if e_max <= 0:
        return torch.zeros(alpha.shape, dtype=torch.int32, device=alpha.device)
    best_k = 1 + torch.argmax(dytc_objective_grid(alpha, c, e_max), dim=1)
    gate = torch.gather(t_sd_grid(alpha, c, e_max), 1, best_k[:, None])[:, 0]
    return torch.where(gate >= t_min, best_k.to(torch.int32), 0)
