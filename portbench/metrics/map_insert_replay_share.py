"""Share of the backbone's map inserts (not fused with the association)
that replayed a captured CUDA graph: the program's
``map_insert.graph_replays`` counter over its ``map_insert`` spans
(``ovo_tpu_torch/utils/trace.py``) in the traced window. None where the
program counts no insert as replayed or eager (a program without the
graph), or records no insert."""
UNIT = "%"
COUNTERS = ("map_insert.graph_replays", "map_insert.eager")


def read(r):
    try:
        from ovo_tpu_torch.utils import trace
    except ImportError:
        return None
    rec = trace.records()
    inserts = sum(1 for s in rec.spans if s.name == "map_insert")
    if not inserts or not any(k in rec.counters for k in COUNTERS):
        return None
    return 100.0 * rec.counters.get("map_insert.graph_replays", 0) / inserts
