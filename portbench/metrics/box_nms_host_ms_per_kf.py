"""Host time of the AMG's greedy box NMS per segmented keyframe: the
program's ``mask_source.box_nms`` spans (``ovo_tpu_torch/utils/trace.py``)
of the traced window. None where the program records none."""
UNIT = "ms"


def read(r):
    try:
        from ovo_tpu_torch.utils import trace
    except ImportError:
        return None
    ns = [s.t1_ns - s.t0_ns for s in trace.records().spans
          if s.name == "mask_source.box_nms"]
    if not ns or not r.n_kf:
        return None
    return sum(ns) / 1e6 / r.n_kf
