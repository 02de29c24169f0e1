"""The one traffic generator: a mix file of parameters in, a request table
and prompt tokens out.

The table (each request's prompt length, output length and, in an open
loop, its arrival offset) comes from the mix's own ``schedule_seed``, and
each request's prompt (uniform token ids from the configuration's
vocabulary) from the mix's ``content_seed`` and its index. ``--seed``
orders the requests: within each block of ``shuffle_block`` consecutive
requests it permutes which request takes which place, the places (the
arrival times of an open loop, the queue positions of an offline one)
staying where they are. So every seed serves the same set of sizes and
prompts at the same times, in another order: the served model's
acceptance, which the prompts' tokens set, is the same work for every
seed.

Lengths are lognormal with log-spread ``sigma`` about the source's
published ``median``, or about the median that gives its published
``mean`` (median = mean / exp(sigma^2 / 2)), rounded and clipped to
[``min``, ``max``]. Open-loop arrivals are a Poisson process at the
cell's rate (``cells/<cell>.json``: ``rate_per_s``): unit-rate exponential
gaps scaled by 1 / rate, so one table serves every rate.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

KINDS = ("open", "offline")


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    index: int
    prompt_len: int
    output_len: int
    due_s: Optional[float]        # arrival offset from the schedule's start (open loop)


def log_median(dist: dict) -> float:
    """The log of the distribution's median, from ``median`` or ``mean``."""
    sigma = float(dist["sigma"])
    if "median" in dist:
        return float(np.log(float(dist["median"])))
    return float(np.log(float(dist["mean"])) - sigma * sigma / 2)


def _lengths(rng: np.random.Generator, dist: dict, n: int) -> np.ndarray:
    z = rng.standard_normal(n)
    x = np.exp(log_median(dist) + float(dist["sigma"]) * z)
    return np.clip(np.rint(x), int(dist["min"]), int(dist["max"])).astype(np.int64)


def table(mix: dict, rate_per_s: Optional[float] = None) -> List[RequestSpec]:
    """The mix's request table: the same for every ``--seed``. An open
    mix needs the cell's arrival rate."""
    if mix["kind"] not in KINDS:
        raise ValueError(f"mix kind {mix['kind']!r}; pick one of {KINDS}")
    n = int(mix["requests"])
    rng = np.random.default_rng(int(mix["schedule_seed"]))
    prompts = _lengths(rng, mix["prompt"], n)
    outputs = _lengths(rng, mix["output"], n)
    gaps = rng.standard_exponential(n)
    due: List[Optional[float]] = [None] * n
    if mix["kind"] == "open":
        if not rate_per_s:
            raise ValueError(f"open mix {mix['name']!r} needs the cell's rate_per_s")
        due = [float(t) for t in np.cumsum(gaps) / float(rate_per_s)]
    return [RequestSpec(i, int(prompts[i]), int(outputs[i]), due[i]) for i in range(n)]


def _seed_words(seed: int) -> List[int]:
    """A non-negative entropy word list for any whole number."""
    return [abs(int(seed)), 1 if int(seed) < 0 else 0]


def served(mix: dict, seed: int, rate_per_s: Optional[float] = None) -> List[RequestSpec]:
    """The table in ``--seed``'s order: place i keeps its arrival offset
    and takes the request (index, lengths) that the seed's permutation of
    i's block puts there."""
    base = table(mix, rate_per_s)
    block = int(mix["shuffle_block"])
    rng = np.random.default_rng(np.random.SeedSequence(_seed_words(seed) + [0x0DE5]))
    out = []
    for b0 in range(0, len(base), block):
        part = base[b0:b0 + block]
        for place, k in zip(part, rng.permutation(len(part))):
            req = part[int(k)]
            out.append(dataclasses.replace(req, due_s=place.due_s))
    return out


def prompt_tokens(mix: dict, spec: RequestSpec, vocab_size: int) -> np.ndarray:
    """Request ``spec``'s prompt: uniform ids in [0, vocab_size), int32,
    from the mix's ``content_seed`` and the request's index (its own
    stream)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(mix["content_seed"]), spec.index]))
    return rng.integers(0, vocab_size, size=spec.prompt_len, dtype=np.int64).astype(np.int32)


def warm_tokens(n: int, vocab_size: int, salt: int = 0) -> np.ndarray:
    """Fixed tokens for warm-up prefills: the same in every run."""
    rng = np.random.default_rng(np.random.SeedSequence([0x5EED, salt, n]))
    return rng.integers(0, vocab_size, size=n, dtype=np.int64).astype(np.int32)


def longest(table_: List[RequestSpec]) -> int:
    """The most positions one request needs: its prompt and its output."""
    return max(s.prompt_len for s in table_) + max(s.output_len for s in table_)
