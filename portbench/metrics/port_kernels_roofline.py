"""The port's hand-written kernels' share of their roofline."""
from portbench import readers

UNIT = "%"


def read(r):
    return readers.kernels_roofline(r)
