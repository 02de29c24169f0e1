"""EWIF of vanilla SD and the DyTC objective (Eq. 5) with its argmax, host
math; a copy of the reference's ``core/ewif.py`` functions the scheduler
and the batched server need."""
from __future__ import annotations

import math
from typing import Tuple


def t_sd(alpha: float, c: float, k: int) -> float:
    """EWIF of vanilla SD: (1 - a^{k+1}) / ((1-a)(ck + 1))."""
    if alpha >= 1.0:
        return (k + 1) / (c * k + 1)
    return (1.0 - alpha ** (k + 1)) / ((1.0 - alpha) * (c * k + 1.0))


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
