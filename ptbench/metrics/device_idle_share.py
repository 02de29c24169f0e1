"""Per cent of the traced stretch with no operation on the device."""
from ptb.measures import idle_share


def read(w):
    return idle_share(w)
