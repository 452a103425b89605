"""Host time blocked on device values per segmented keyframe: the
program's ``wait.*`` spans (``ovo_tpu_torch/utils/trace.py``) of the traced
window. None where the program records no spans."""
UNIT = "ms"


def read(r):
    try:
        from ovo_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.records().spans
    if not spans or not r.n_kf:
        return None
    ns = sum(s.t1_ns - s.t0_ns for s in spans if s.name.startswith("wait."))
    return ns / 1e6 / r.n_kf
