"""90th percentile of per-request TPOT over the requests finished in the
window (tens of requests: too few for a judged tail)."""
from ptb.measures import request_tpots
from ptb.stats import percentile


def read(w):
    v = percentile(request_tpots(w), 90)
    return None if v is None else 1000.0 * v
