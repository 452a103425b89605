"""The whole step's share of the card's peak (model FLOPs from shapes)."""
from portbench import readers

UNIT = "%"


def read(r):
    return readers.mfu(r)
