"""The card's idle share of the traced window."""
from portbench import readers

UNIT = "%"


def read(r):
    return readers.idle_share(r)
