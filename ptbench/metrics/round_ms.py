"""Window time outside the admission spans, over the rounds in the window."""
from ptb.measures import round_ms


def read(w):
    return round_ms(w)
