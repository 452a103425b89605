"""Device time of the crop embedder (crops, SigLIP towers, merger) per segmented keyframe."""
from portbench import readers

UNIT = "ms"


def read(r):
    return readers.span_ms_per_kf(r, "embedder") if r.embed_type != "TextRegion" else None
