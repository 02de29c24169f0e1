"""90th percentile of due time to first delivery, over the requests first
served in the window."""
from ptb.measures import ttfts
from ptb.stats import percentile


def read(w):
    v = percentile(ttfts(w), 90)
    return None if v is None else 1000.0 * v
