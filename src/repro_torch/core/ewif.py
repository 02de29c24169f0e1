"""EWIF of vanilla SD, of the multi-level cascade and the DyTC objective
(Eq. 5) with their argmaxes; a copy of the reference's ``core/ewif.py``
functions the scheduler and the batched server need: host math, and the
``*_grid`` tensor forms the single-dispatch serving round evaluates on the
device."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def t_sd(alpha: float, c: float, k: int) -> float:
    """EWIF of vanilla SD: (1 - a^{k+1}) / ((1-a)(ck + 1))."""
    if alpha >= 1.0:
        return (k + 1) / (c * k + 1)
    return (1.0 - alpha ** (k + 1)) / ((1.0 - alpha) * (c * k + 1.0))


def t_sd_grid(alpha: torch.Tensor, c, k_max: int) -> torch.Tensor:
    """``t_sd`` over slots and chain lengths: ``alpha`` (B,) float32, ``c``
    a scalar; returns (B, k_max + 1) float32 for k = 0..k_max (k = 0, plain
    AR, is exactly 1)."""
    ks = torch.arange(k_max + 1, dtype=torch.float32, device=alpha.device)[None, :]
    a = alpha.float()[:, None]
    a_safe = torch.clamp(a, max=1.0 - 1e-9)
    v = (1.0 - a_safe ** (ks + 1.0)) / ((1.0 - a_safe) * (c * ks + 1.0))
    return torch.where(a >= 1.0, (ks + 1.0) / (c * ks + 1.0), v)


def dytc_objective_grid(alpha: torch.Tensor, c, k_max: int) -> torch.Tensor:
    """``dytc_step_objective`` with the drafter as its own continuation
    (alpha_dn = alpha, c_dn = c) over slots and k = 1..k_max: (B, k_max)."""
    ks = torch.arange(1, k_max + 1, dtype=torch.float32, device=alpha.device)[None, :]
    a = alpha.float()[:, None]
    a_safe = torch.clamp(a, max=1.0 - 1e-9)
    e_acc = torch.where(a >= 1.0, ks, a_safe * (1.0 - a_safe ** ks) / (1.0 - a_safe))
    return (e_acc + (a_safe ** ks) * a_safe) / (c * ks + c)


def t_cascade(alphas: Sequence[float], cs: Sequence[float], k: int) -> float:
    """EWIF of an L-level vertical draft cascade, one inner round per level
    (``cascade_fused``): the cheapest level drafts ``k`` tokens in one scan,
    every stronger level verifies-and-extends the proposal in one block
    forward, then the target verifies.

      - ``alphas[0]``   — target's acceptance of the strongest level's tokens
      - ``alphas[i>0]`` — level i-1's acceptance of level i's tokens
      - ``cs[i]``       — cost coefficient of level i (vs one target forward)

    Time per round: ``cs[-1]*k`` + ``sum(cs[:-1])`` + 1. Tokens per round:
    each level turns an e-token proposal into an expected ``(1 - a^{e+1}) /
    (1 - a)`` endorsed chain, and the target's acceptance of the final chain
    uses the same form.
    """
    if len(alphas) != len(cs) or not alphas:
        raise ValueError("alphas and cs must be equal-length, non-empty")
    e = float(k)
    for a in reversed(list(alphas)):           # cheapest-adjacent level first
        a = min(float(a), 1.0 - 1e-9)
        e = (1.0 - a ** (e + 1.0)) / (1.0 - a)
    # after folding alphas[0] the recursion already counts the bonus token
    time = 1.0 + cs[-1] * k + sum(cs[:-1])
    return e / time


def best_cascade_k(alphas: Sequence[float], cs: Sequence[float], k_max: int) -> Tuple[float, int]:
    """argmax_k of the cascade EWIF (the Eq. 5 budget of the cheapest
    level's drafting scan). Returns (best value, best k); k=0 means the
    cascade never beats plain verification."""
    best_v, best_k = -math.inf, 0
    for k in range(1, max(k_max, 0) + 1):
        v = t_cascade(alphas, cs, k)
        if v > best_v:
            best_v, best_k = v, k
    return best_v, best_k


def dytc_step_objective(alpha: float, c: float, k: int, alpha_dn: float, c_dn: float) -> float:
    """Eq. 5 admissible objective: (E_acc + a^k a_dn) / (c k + c_dn)."""
    if c * k + c_dn <= 1e-12:
        return -math.inf
    e_acc = k if alpha >= 1.0 else alpha * (1.0 - alpha ** k) / (1.0 - alpha)
    return (e_acc + (alpha ** k) * alpha_dn) / (c * k + c_dn)


def best_dytc_k(
    alpha: float, c: float, alpha_dn: float, c_dn: float, k_max: int
) -> Tuple[float, int]:
    """argmax_k of the Eq. 5 objective for one configuration.
    Returns (best value, best k)."""
    best_v, best_k = -math.inf, 0
    for k in range(1, max(k_max, 0) + 1):
        v = dytc_step_objective(alpha, c, k, alpha_dn, c_dn)
        if v > best_v:
            best_v, best_k = v, k
    return best_v, best_k
