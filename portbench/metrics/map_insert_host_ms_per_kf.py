"""Host time of the backbone's map insert (not fused with the
association) per segmented keyframe: the program's ``map_insert`` spans
(``ovo_tpu_torch/utils/trace.py``) of the traced window less the
``wait.*`` spans inside them. None where the program records none."""
UNIT = "ms"
ROOT = "map_insert"


def _inside(spans, i):
    p = spans[i].parent
    while p >= 0:
        if spans[p].name == ROOT:
            return True
        p = spans[p].parent
    return False


def read(r):
    try:
        from ovo_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.records().spans
    roots = [s.t1_ns - s.t0_ns for s in spans if s.name == ROOT]
    if not roots or not r.n_kf:
        return None
    waits = sum(s.t1_ns - s.t0_ns for i, s in enumerate(spans)
                if s.name.startswith("wait.") and _inside(spans, i))
    return (sum(roots) - waits) / 1e6 / r.n_kf
