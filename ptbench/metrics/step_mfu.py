"""Per cent of the dtype's peak that an autoregressive target forward
would need for the window's delivered tokens and admitted prompts."""
from ptb.measures import step_mfu
from ptb.peaks import peak_flops


def read(w):
    return step_mfu(w, peak_flops(w.cfg["dtype"]))
