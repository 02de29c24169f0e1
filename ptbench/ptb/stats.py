"""Order statistics from raw samples (no histogram buckets)."""
from __future__ import annotations

import statistics
from typing import Optional, Sequence


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """The ``p``-th percentile of the raw samples, linear between order
    statistics (rank p / 100 * (n - 1)); None for no samples."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    r = p / 100.0 * (len(xs) - 1)
    lo = int(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of the
    median, quartiles as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med
