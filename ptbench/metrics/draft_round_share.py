"""Per cent of the window's rounds that ran the draft segment."""
from ptb.measures import draft_round_share


def read(w):
    return draft_round_share(w)
