"""Every token routed to a request inside the window (overshoot past a
budget excluded), over the window's seconds."""
from ptb.measures import window_tokens


def read(w):
    return window_tokens(w) / w.seconds
