"""The whole window's time per output token: over every request, the gaps
between consecutive deliveries that both fall in the window, summed, over
the tokens those later deliveries brought."""
from ptb.measures import window_gaps


def read(w):
    gaps, toks = window_gaps(w)
    return 1000.0 * sum(gaps) / sum(toks) if sum(toks) else None
