"""Device time of the SAM2 mask source per segmented keyframe."""
from portbench import readers

UNIT = "ms"


def read(r):
    return readers.span_ms_per_kf(r, "mask_source")
