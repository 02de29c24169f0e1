"""Mean drain + admit span time per admission (the eager prefill of one
request), in the window."""
from ptb.measures import admit_ms


def read(w):
    return admit_ms(w)
