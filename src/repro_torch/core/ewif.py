"""EWIF theory from §3 and Appendix B of CAS-Spec (following CS-Drafting);
a copy of the reference's ``core/ewif.py``.

Expected Walltime Improvement Factor under i.i.d. Bernoulli acceptance:

  T_SD(a, c, k)  — vanilla speculative decoding, Eq. in §3
  T_VC           — vertical cascade (Eq. 1)
  T_HC           — horizontal cascade (Eq. 2)
  T_cascade      — the multi-level cascade of ``cascade_fused``
  bounds         — Appendix B effective bounds on c_d1
  the DyTC objective (Eq. 5) and the greedy strawman of §4.2.

Host math in plain floats (the schedulers and the batched server's split
rounds), numpy for the Monte-Carlo cross-check, and the ``*_grid`` tensor
forms the single-dispatch serving round evaluates on the device."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
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


def expected_accepted(alpha: float, k: int) -> float:
    """E[# accepted draft tokens] = a(1-a^k)/(1-a)."""
    if alpha >= 1.0:
        return float(k)
    return alpha * (1.0 - alpha ** k) / (1.0 - alpha)


def phi_sd(alpha: float, c: float, k: int) -> float:
    """Inner-stage EWIF used in the Appendix-B vertical-cascade bound."""
    return t_sd(alpha, c, k)


def t_vc(
    alpha_t_d1: float,
    alpha_d1_d2: float,
    c_d1: float,
    c_d2: float,
    n: int,
    k: int,
) -> float:
    """Vertical cascade EWIF (Eq. 1 / Appendix B form).

    M_d1 drafts n rounds for the target; each M_d1 round is itself
    accelerated by M_d2 drafting k tokens (e.g. PLD under a layer-sparse
    draft). phi is the EWIF of the inner (M_d1, M_d2) stage.
    """
    a = alpha_t_d1
    # Eq. 1: T_VC = (1 - a·phi^n(a)) / ((1-a)(1 + n c_d1 + n k c_d2)).
    # Under the i.i.d. Bernoulli model, phi is the pgf of the inner
    # (M_d1, M_d2) stage and a·phi^n(a) = a^{n·E_inner} where E_inner is the
    # expected tokens produced per inner round, (1 - a2^{k+1}) / (1 - a2).
    a2 = alpha_d1_d2
    e_inner = (1.0 - a2 ** (k + 1)) / (1.0 - a2) if a2 < 1 else float(k + 1)
    den_time = 1.0 + n * c_d1 + n * k * c_d2
    if a >= 1.0:
        return (n * e_inner) / den_time
    return (1.0 - a ** (n * e_inner)) / ((1.0 - a) * den_time)


def t_hc(
    alpha_d1: float,
    alpha_d2: float,
    c_d1: float,
    c_d2: float,
    k_d1: int,
    k_d2: int,
) -> float:
    """Horizontal cascade EWIF (Eq. 2): early tokens by the better draft."""
    a1, a2 = alpha_d1, alpha_d2
    num1 = (1.0 - a1 ** (k_d1 + 1)) / (1.0 - a1) if a1 < 1 else k_d1 + 1
    num2 = a1 ** k_d1 * (a2 * (1.0 - a2 ** k_d2) / (1.0 - a2) if a2 < 1 else k_d2)
    den = 1.0 + k_d1 * c_d1 + k_d2 * c_d2
    return (num1 + num2) / den


def best_sd(alpha: float, c: float, k_max: int = 32) -> Tuple[float, int]:
    vals = [(t_sd(alpha, c, k), k) for k in range(1, k_max + 1)]
    return max(vals)


def best_hc(
    alpha_d1: float, alpha_d2: float, c_d1: float, c_d2: float, k_max: int = 16
) -> Tuple[float, Tuple[int, int]]:
    best = (-1.0, (1, 1))
    for k1 in range(1, k_max + 1):
        for k2 in range(0, k_max + 1):
            v = t_hc(alpha_d1, alpha_d2, c_d1, c_d2, k1, k2)
            if v > best[0]:
                best = (v, (k1, k2))
    return best


def best_vc(
    alpha_t_d1: float,
    alpha_d1_d2: float,
    c_d1: float,
    c_d2: float,
    n_max: int = 8,
    k_max: int = 16,
) -> Tuple[float, Tuple[int, int]]:
    best = (-1.0, (1, 1))
    for n in range(1, n_max + 1):
        for k in range(1, k_max + 1):
            v = t_vc(alpha_t_d1, alpha_d1_d2, c_d1, c_d2, n, k)
            if v > best[0]:
                best = (v, (n, k))
    return best


# --------------------------------------------------------- Appendix B bounds
def hc_bound_c_d1(
    alpha_d1: float, alpha_d2: float, c_d2: float, k_d1: int, k_d2: int, k_0: int
) -> float:
    """Max c_d1 such that T_HC >= T_SD(M_d2) at the given hyperparameters."""
    a1, a2 = alpha_d1, alpha_d2
    num1 = (1.0 - a1 ** (k_d1 + 1)) / (1.0 - a1)
    num2 = a1 ** k_d1 * a2 * (1.0 - a2 ** k_d2) / (1.0 - a2)
    rhs = (1.0 - a2) * (c_d2 * k_d2 + 1.0) / (1.0 - a2 ** (k_d2 + 1))
    # NOTE: Appendix B writes the SD reference at k_d2; we use k_0 for the
    # standalone-SD leg per the inequality T_HC >= T_SD(M_d2; k_0).
    rhs0 = (1.0 - a2) * (c_d2 * k_0 + 1.0) / (1.0 - a2 ** (k_0 + 1))
    return ((num1 + num2) * rhs0 - (1.0 + k_d2 * c_d2)) / k_d1


def vc_bound_c_d1_numeric(
    alpha_t_d1: float,
    alpha_d1_d2: float,
    alpha_t_d2: float,
    c_d2: float,
    n_max: int = 8,
    k_max: int = 16,
    tol: float = 1e-4,
) -> float:
    """Largest c_d1 with max-hyperparam T_VC >= max-hyperparam T_SD(M_d2).

    Eq. 3 has no closed form over the integer hyperparameters — numeric
    bisection over c_d1, exactly as the paper's simulation (Fig. 1b).
    """
    target, _ = best_sd(alpha_t_d2, c_d2)
    lo, hi = 0.0, 1.0
    if best_vc(alpha_t_d1, alpha_d1_d2, lo, c_d2, n_max, k_max)[0] < target:
        return 0.0
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if best_vc(alpha_t_d1, alpha_d1_d2, mid, c_d2, n_max, k_max)[0] >= target:
            lo = mid
        else:
            hi = mid
    return lo


def hc_bound_c_d1_numeric(
    alpha_t_d1: float,
    alpha_t_d2: float,
    c_d2: float,
    k_max: int = 16,
    tol: float = 1e-4,
) -> float:
    """Largest c_d1 with max-hyperparam T_HC >= max-hyperparam T_SD(M_d2)."""
    target, _ = best_sd(alpha_t_d2, c_d2)
    lo, hi = 0.0, 1.0
    if best_hc(alpha_t_d1, alpha_t_d2, lo, c_d2, k_max)[0] < target:
        return 0.0
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if best_hc(alpha_t_d1, alpha_t_d2, mid, c_d2, k_max)[0] >= target:
            lo = mid
        else:
            hi = mid
    return lo


# -------------------------------------------------- multi-level cascade EWIF
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


def greedy_step_objective(alpha: float, c: float, k: int) -> float:
    """Greedy local speedup (the §4.2 strawman): a(1-a^k)/((1-a) c k)."""
    if c * k <= 1e-12:
        return math.inf
    e_acc = k if alpha >= 1.0 else alpha * (1.0 - alpha ** k) / (1.0 - alpha)
    return e_acc / (c * k)


# -------------------------------------------------- Monte-Carlo cross-check
def simulate_ewif_sd(
    alpha: float, c: float, k: int, steps: int = 20000, seed: int = 0
) -> float:
    """MC estimate of SD EWIF under i.i.d. Bernoulli acceptance."""
    rng = np.random.default_rng(seed)
    acc = rng.random((steps, k)) < alpha
    # tokens per round: accepted prefix + 1 bonus
    prefix = np.argmin(acc, axis=1)
    prefix = np.where(acc.all(axis=1), k, prefix)
    tokens = prefix + 1
    time_per_round = c * k + 1.0
    return float(tokens.mean() / time_per_round)
