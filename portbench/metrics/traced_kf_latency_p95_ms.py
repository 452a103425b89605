"""The keyframe latency's 95th percentile in the traced window, where its
spread cannot hold an end-to-end bound."""
from portbench import readers

UNIT = "ms"


def read(r):
    return readers.latency_p95_ms(r)
