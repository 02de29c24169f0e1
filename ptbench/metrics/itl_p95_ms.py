"""The 95th percentile of the window's gaps between consecutive deliveries
to a request (each gap one sample), from the raw samples."""
from ptb.measures import window_gaps
from ptb.stats import percentile


def read(w):
    gaps, _ = window_gaps(w)
    v = percentile(gaps, 95)
    return None if v is None else 1000.0 * v
