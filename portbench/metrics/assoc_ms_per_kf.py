"""Device time of the association and the map inserts per segmented keyframe."""
from portbench import readers

UNIT = "ms"


def read(r):
    return readers.span_ms_per_kf(r, "association", "map_insert")
