"""Host synchronizations in the pipeline loop per segmented keyframe."""
from portbench import readers

UNIT = "count/kf"


def read(r):
    return readers.host_syncs_per_kf(r)
