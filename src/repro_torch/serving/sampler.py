"""Token samplers: greedy / temperature / top-k / top-p. A copy of the
reference's ``serving/sampler.py`` (numpy, float64).

``SamplingParams`` is the per-request sampling contract carried through
admission into the rounds (serving/server.py); ``warp_probs`` is the
host twin of the tensor ``core.verify.sampling_probs`` — same
temperature scaling, same EXACT-k top-k (ties at the kth value broken by
token index, stable sort), same top-p boundary rule (a token is kept iff
the cumulative mass BEFORE it is < top_p, which matches
``searchsorted(cum, top_p, side='left') + 1`` tokens even when top_p lands
exactly on a cumulative boundary). The two are pinned bit-for-bit against
each other in the reference's tests and held against the reference's
copy in tests/test_torch_sampling.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["SamplingParams", "warp_probs", "sample_token"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature <= 0 means greedy: the request routes through the existing
    greedy kernels and its output is token-identical to a no-sampling
    server. top_k <= 0 disables the top-k filter; top_p >= 1 disables the
    nucleus filter. ``seed`` fixes the slot's PRNG stream (None -> the
    server derives one from its base seed and the admission counter).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def warp_probs(
    logits: np.ndarray,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> np.ndarray:
    """The warped target distribution q over (V,) logits (host reference).

    temperature=0 -> a point mass at argmax. Otherwise: scale by the
    temperature, keep the exact top-k logits (stable rank — ties at the
    kth value keep the LOWEST token indices, never more than k tokens),
    softmax, then keep the shortest prefix of the sorted probabilities
    whose exclusive cumulative mass is < top_p, and renormalize.
    """
    logits = np.asarray(logits, np.float64)
    if temperature <= 0.0:
        q = np.zeros_like(logits)
        q[np.argmax(logits)] = 1.0
        return q
    x = logits / max(temperature, 1e-6)
    order = np.argsort(-x, kind="stable")       # ties -> lower index first
    rank = np.argsort(order, kind="stable")
    if top_k > 0:
        x = np.where(rank < top_k, x, -np.inf)
    x = x - x.max()
    p = np.exp(x)
    p /= p.sum()
    if top_p < 1.0:
        p_sorted = p[order]
        cum = np.cumsum(p_sorted)
        keep_sorted = (cum - p_sorted) < max(top_p, 1e-9)
        p = np.where(keep_sorted[rank], p, 0.0)
        p /= p.sum()
    return p


def sample_token(
    logits: np.ndarray,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Sample one token from (V,) logits. temperature=0 -> greedy."""
    q = warp_probs(logits, temperature, top_k, top_p)
    if temperature <= 0.0:
        return int(np.argmax(q))
    rng = rng or np.random.default_rng()
    # inverse-CDF draw — the same rule as the device `_inv_cdf`, so a host
    # replay with the same uniform reproduces the device token exactly
    cum = np.cumsum(q)
    return int(np.argmax(cum > rng.random() * cum[-1]))
