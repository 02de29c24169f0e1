"""Accepted tokens over live slot-rounds in the window (the drained ring)."""
from ptb.measures import tokens_per_slot_round


def read(w):
    return tokens_per_slot_round(w)
