"""Process start to the window's start: weights, server build and graph
capture, warm-up, and (open loop) the arrivals' lead-in."""


def read(w):
    return w.setup_s
