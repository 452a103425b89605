"""Host time of the pipeline loop outside the layer spans per keyframe."""
from portbench import readers

UNIT = "ms"


def read(r):
    return readers.loop_host_ms_per_kf(r)
