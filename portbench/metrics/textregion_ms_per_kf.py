"""Device time of the TextRegion embedder per segmented keyframe."""
from portbench import readers

UNIT = "ms"


def read(r):
    return readers.span_ms_per_kf(r, "embedder") if r.embed_type == "TextRegion" else None
