"""What a run records of the program as it runs, and how the reference
judges it afterwards.

``Probe`` wraps the program's entry points on the pipeline object (the mask
source, the embedder, ``SemanticMapper._associate``, the backbone's map
insert, ``OVOSemMap._step``) to record, for the harness's spans and
clocks, when each call began and ended on the host and, through a CUDA
event, when its work ended on the card. For the keyframes and the map frame
drawn from the seed it also keeps copies of what went in and what came out.
Nothing it does waits for the card.

``judge`` then has the reference recompute each sampled stage from the
benchmark's own frames and weights. The run's first association starts
from the reference's own empty map and store, into which the reference
inserts the frames the program mapped before it; a window keyframe's
association and a map frame's insert start from the program's map and
store just before that stage (the reference follows the program step by
step there). The descriptors are the reference's, on the fused masks and
keep flags of the reference's association.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .reference import precision
from .reference.mapping import association as ref_assoc
from .reference.mapping import instances as ref_inst
from .reference.mapping import map_state as ref_map


class Clock:
    """Host marks with, on the card, a CUDA event each; converted to host
    seconds after the run through one reference event."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[tuple] = []

    def mark(self) -> int:
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self.marks.append((time.perf_counter(), ev))
        return len(self.marks) - 1

    def device_s(self, ref: int, i: int) -> float:
        """Mark ``i``'s completion on the card in host seconds, from the
        reference mark ``ref`` taken on an idle card (after a synchronize).
        Without a card: the host time of the mark."""
        t0, e0 = self.marks[ref]
        t, e = self.marks[i]
        if e is None:
            return t
        return t0 + e0.elapsed_time(e) / 1e3


def _clone(obj):
    """A deep copy of a state dataclass's tensors."""
    return type(obj)(**{f.name: getattr(obj, f.name).clone()
                        for f in dataclasses.fields(obj)})


class HostCopies:
    """Copies of device tensors in host memory, enqueued on the stream: a
    copy reads the tensor as it stands at that point of the stream, before
    any later in-place update, and nothing waits for it. On the card the
    copies land in pinned buffers reserved during set-up, so that the
    samples the judge needs take no device memory (the run's peak is the
    program's) and no allocation happens inside the window. Without a
    card: clones."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pool: Dict[tuple, List[torch.Tensor]] = {}

    def reserve(self, t: torch.Tensor, n: int) -> None:
        if self.cuda:
            key = (tuple(t.shape), t.dtype)
            self.pool.setdefault(key, []).extend(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for _ in range(n))

    def reserve_state(self, obj, n: int) -> None:
        for f in dataclasses.fields(obj):
            self.reserve(getattr(obj, f.name), n)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return t.clone()
        free = self.pool.get((tuple(t.shape), t.dtype))
        buf = free.pop() if free else torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    def state(self, obj):
        return type(obj)(**{f.name: self.copy(getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})


def on(device, obj):
    """A host copy (tensor or state dataclass) back on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                        for f in dataclasses.fields(obj)})


def resident(c: Optional[Dict[str, Any]], device) -> Optional[Dict[str, Any]]:
    """A sampled stage's copies on ``device``; the masks associated are
    the mask source's where the program passed those on unchanged."""
    if c is None:
        return None
    out = {k: on(device, v) if isinstance(v, torch.Tensor)
           or dataclasses.is_dataclass(v) else v for k, v in c.items()}
    for k in ("seg", "bmaps", "valid"):
        if k in out:
            out.setdefault("a_" + k, out[k])
    return out


def _as(cls, obj):
    """A program state dataclass as the reference's class of that name."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


class Probe:
    """Records spans, marks and sampled states of one pipeline object."""

    def __init__(self, sem_map, clock: Clock, copies: HostCopies):
        self.sm, self.clock, self.copies = sem_map, clock, copies
        ovo = sem_map.ovo
        self.segment_every = sem_map.segment_every
        self.spans: List[tuple] = []          # (name, t0_ns, t1_ns)
        self.kf_take: Dict[int, float] = {}   # fid -> host s of its _step
        self.kf_done: Dict[int, int] = {}     # fid -> mark after _associate
        self.segmented: List[int] = []        # fids through the mask source
        self.valid_counts: List[torch.Tensor] = []
        self.samples: set = set()
        self.map_samples: set = set()
        # the run's first association and the frames mapped before it
        self.start_fid: Optional[int] = None
        self.inserted: List[int] = []
        self.cap: Dict[int, Dict[str, Any]] = {}
        self.end_mark: Optional[int] = None

        self._source = ovo.mask_source
        ovo.mask_source = _Passthrough(self._source)
        ovo.mask_source.get_masks = self._get_masks
        if hasattr(self._source, "get_masks_batch"):
            ovo.mask_source.get_masks_batch = self._get_masks_batch
        self._embedder = ovo.embedder
        ovo.embedder = _Passthrough(self._embedder)
        ovo.embedder.embed_masks = self._embed
        if hasattr(self._embedder, "embed_masks_batch"):
            ovo.embedder.embed_masks_batch = self._embed_batch
        self._associate = ovo._associate
        ovo._associate = self._assoc
        bb = sem_map.slam_backbone
        self._map = bb.map
        bb.map = self._map_insert
        self._step = sem_map._step
        sem_map._step = self._step_wrap
        # the checkpoint write is no part of the window: the run's end is
        # marked where it would start
        sem_map.save_representation = self._end

    def reserve(self, n_kf: int, image_hw, n_masks: int) -> None:
        """Host buffers for ``n_kf`` sampled keyframes and one map frame,
        in the shapes the pipeline holds now (a buffer that does not fit a
        later shape is made when needed)."""
        cp, ovo = self.copies, self.sm.ovo
        cp.reserve_state(self.sm.slam_backbone.get_map(), 2 * n_kf + 2)
        cp.reserve_state(ovo.store, 2 * n_kf)
        H, W = image_hw
        cp.reserve(torch.empty((n_masks, H, W), dtype=torch.bool,
                               device="meta"), 2 * n_kf)
        cp.reserve(torch.empty((H, W), dtype=torch.int32, device="meta"), n_kf)
        for dt in (torch.bool, torch.bool, torch.int32, torch.bool):
            cp.reserve(torch.empty((n_masks,), dtype=dt, device="meta"), n_kf)

    # -- spans ------------------------------------------------------------
    def _span(self, name, fn, *args, **kw):
        t0 = time.time_ns()
        try:
            return fn(*args, **kw)
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def _step_wrap(self, frame_id, frame_data):
        if frame_id % self.segment_every == 0:
            self.kf_take[frame_id] = time.perf_counter()
        return self._step(frame_id, frame_data)

    def _end(self):
        self.end_mark = self.clock.mark()

    # -- the mask source ----------------------------------------------------
    def _keep_masks(self, fid, seg, bmaps, valid):
        self.segmented.append(fid)
        self.valid_counts.append(valid.sum())
        if fid in self.samples:
            cp = self.copies
            self.cap.setdefault(fid, {}).update(
                seg=cp.copy(seg), bmaps=cp.copy(bmaps), valid=cp.copy(valid),
                src=(seg.data_ptr(), bmaps.data_ptr(), valid.data_ptr()))

    def _get_masks(self, image, frame_id=None):
        out = self._span("mask_source", self._source.get_masks, image,
                         frame_id)
        if out[0] is not None:
            self._keep_masks(frame_id, *out)
        return out

    def _get_masks_batch(self, images, frame_ids=None):
        out = self._span("mask_source", self._source.get_masks_batch, images,
                         frame_ids)
        for j, fid in enumerate(frame_ids):
            self._keep_masks(fid, out[0][j], out[1][j], out[2][j])
        return out

    # -- the embedder ---------------------------------------------------------
    def _embed(self, image, binary_maps, valid):
        return self._span("embedder", self._embedder.embed_masks, image,
                          binary_maps, valid)

    def _embed_batch(self, images, binary_maps, valid):
        return self._span("embedder", self._embedder.embed_masks_batch,
                          images, binary_maps, valid)

    # -- association and the map insert -------------------------------------
    def _assoc(self, *args, **kw):
        fid = args[0]
        ovo = self.sm.ovo
        c = None
        start = self.start_fid is None
        if start:
            self.start_fid = fid
        if fid in self.samples or start:
            cp = self.copies
            c = self.cap.setdefault(fid, {})
            if start:
                c.update(start=True, inserted=list(self.inserted))
            # the masks associated are the ones the mask source returned
            # unless the program changed them in between
            same = c.get("src") == tuple(a.data_ptr() for a in args[5:8])
            c.update(map_in=cp.state(args[8]), store_in=cp.state(ovo.store),
                     depth=args[2], ratio=args[3], c2w=np.asarray(args[4]),
                     insert=kw.get("insert"), kf_id=ovo.kf_id)
            if not same:
                c.update(a_seg=cp.copy(args[5]), a_bmaps=cp.copy(args[6]),
                         a_valid=cp.copy(args[7]))
        out = self._span("association", self._associate, *args, **kw)
        self.kf_done[fid] = self.clock.mark()
        if c is not None:
            q = ovo.keyframes_queue[-1]
            c.update(map_out=cp.state(out), store_out=cp.state(ovo.store),
                     ins_ids=cp.copy(q["ins_ids"]), keep=cp.copy(q["keep"]),
                     fused_maps=cp.copy(q["fused_maps"]))
        return out

    def _map_insert(self, frame_data, c2w):
        fid = frame_data[0]
        bb = self.sm.slam_backbone
        if self.start_fid is None:
            self.inserted.append(fid)
        if fid in self.map_samples:
            self.cap.setdefault(fid, {}).update(
                state_in=self.copies.state(bb.state), frame=frame_data,
                c2w_map=np.asarray(c2w))
        self._span("map_insert", self._map, frame_data, c2w)
        if fid in self.map_samples:
            self.cap[fid]["state_out"] = self.copies.state(bb.state)


class _Passthrough:
    """Stands in for a program object: attributes set on it shadow the
    object's, every other one is the object's."""

    def __init__(self, inner):
        self.__dict__["_inner"] = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ---------------------------------------------------------------------------
# judging
# ---------------------------------------------------------------------------

def _mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum())


def _ctx_precision(lower: bool):
    return precision.tf32() if lower else precision.exact()


def ref_start(c: Dict[str, Any], ctx: Dict[str, Any]):
    """The reference's own map and instance store at the run's first
    association: both empty, at the configuration's sizes, and the frames
    the program mapped before it inserted in the same order from the
    benchmark's frames and poses."""
    dev, semantic = ctx["device"], ctx["semantic"]
    caps, clip = semantic.get("capacity", {}), semantic.get("clip", {})
    n_top = int(clip.get("k_top_views", 0))
    state = ref_map.init_map_state(
        int(ctx["mapping"].get("n_points_capacity", 2 ** 21)), dev)
    for fid in c["inserted"]:
        fd = ctx["dataset"][fid]
        state = _insert(state, fd, np.asarray(fd[3], np.float32), ctx)
    store = ref_inst.init_instance_store(
        int(caps.get("n_instances", 1024)), ctx["clip_dim"],
        n_slots=(int(caps.get("top_k_slots", 16)) if ctx["unbounded_top_k"]
                 else max(n_top, 1)),
        store_slot_descs=clip.get("fusion") in ("l1_medoid",
                                                "cossim_medoid"),
        device=dev)
    return state, store


def ref_association(fid: int, c: Dict[str, Any], ctx: Dict[str, Any],
                    lower: bool = False, start=None) -> Dict[str, Any]:
    """The reference's association of a sampled keyframe (fused with the
    map insert where the program fused it), on the program's masks, from
    ``start`` (the reference's own map and store, :func:`ref_start`) or
    else from the program's map and store just before it: the same fields
    the probe kept of the program's. ``lower``: in TF32 (the control)."""
    dev = ctx["device"]
    semantic = ctx["semantic"]
    c2w = c["c2w"].astype(np.float32)
    ratio = tuple(c["ratio"]) if len(c["ratio"]) else None
    kw = dict(w2c=torch.from_numpy(np.linalg.inv(c2w)).to(dev),
              match_distance_th=float(semantic.get("match_distance_th", 0.05)),
              track_th=int(semantic.get("track_th", 100)),
              use_depth_filter=bool(semantic.get("depth_filter", False)),
              unbounded_top_k=ctx["unbounded_top_k"], rgb_depth_ratio=ratio,
              active_cols=None)
    depth = torch.from_numpy(np.asarray(c["depth"], np.float32)).to(dev)
    kf = torch.full((), c["kf_id"], dtype=torch.int32, device=dev)
    if start is not None:
        state, store = (_clone(start[0]), _clone(start[1]))
    else:
        state = _as(ref_map.MapState, _clone(c["map_in"]))
        store = _as(ref_inst.InstanceStore, _clone(c["store_in"]))
    with torch.no_grad(), _ctx_precision(lower):
        if c["insert"] is not None:
            ins = c["insert"]
            ds = int(ins["downscale"])
            colors = torch.from_numpy(np.ascontiguousarray(
                ctx["dataset"][fid][1][::ds, ::ds])).to(dev)
            st, sto, m = ref_assoc.associate_and_insert_keyframe(
                state, store, c["a_seg"], c["a_bmaps"], c["a_valid"], colors,
                depth, torch.from_numpy(c2w).to(dev), ctx["K"], kf,
                insert_match_th=ins["insert_match_th"],
                k_pooling=ins["k_pooling"], downscale=ins["downscale"],
                active_rows=None, **kw)
        else:
            st, sto, m = ref_assoc.associate_keyframe(
                state, store, c["a_seg"], c["a_bmaps"], c["a_valid"], depth,
                torch.from_numpy(c2w).to(dev), ctx["K"], kf, **kw)
    return dict(map_out=st, store_out=sto, ins_ids=m.ins_ids, keep=m.keep,
                fused_maps=m.fused_maps, insert=c["insert"],
                own_state=start is not None)


def assoc_mismatch(ref: Dict[str, Any], prog: Dict[str, Any]) -> float:
    """The share of entries where two associations of one keyframe differ:
    each mask's instance id, keep flag and fused mask, the store's next
    id, active flags and point counts, the map's count and every live
    row's instance id (and, fused with the insert or from the reference's
    own map, its point, by more than 1e-5 m, and its colour)."""
    po, so = prog["map_out"], prog["store_out"]
    st, sto = ref["map_out"], ref["store_out"]
    bad, total = 0, 0
    for a, b in ((ref["ins_ids"], prog["ins_ids"]), (ref["keep"], prog["keep"]),
                 (ref["fused_maps"], prog["fused_maps"]),
                 (sto.next_id, so.next_id), (sto.active, so.active),
                 (sto.n_points, so.n_points)):
        bad += _mismatch(a, b)
        total += a.numel()
    n_ref, n_prog = int(st.count), int(po.count)
    n = max(n_ref, n_prog)
    total += n + 1
    if n_ref != n_prog:
        return (bad + n + 1) / total
    bad += _mismatch(st.obj_ids[:n], po.obj_ids[:n])
    if prog["insert"] is not None or ref.get("own_state"):
        total += 2 * n
        bad += int(((st.points[:n] - po.points[:n]).abs() > 1e-5).any(1).sum())
        bad += int((st.colors[:n] != po.colors[:n]).any(1).sum())
    return bad / total


def ref_insert(c: Dict[str, Any], ctx: Dict[str, Any], lower: bool = False):
    """The reference's map insert of the sampled map frame from the
    program's map just before it."""
    state = _as(ref_map.MapState, _clone(c["state_in"]))
    return _insert(state, c["frame"], c["c2w_map"].astype(np.float32), ctx,
                   lower)


def _insert(state, fd, c2w, ctx: Dict[str, Any], lower: bool = False):
    """The reference's map insert of frame tuple ``fd`` at pose ``c2w``."""
    dev = ctx["device"]
    mp = ctx["mapping"]
    with torch.no_grad(), _ctx_precision(lower):
        return ref_map.map_insert_frame(
            state, torch.from_numpy(np.ascontiguousarray(fd[1])).to(dev),
            torch.from_numpy(np.asarray(fd[2], np.float32)).to(dev),
            torch.from_numpy(c2w).to(dev), ctx["K"],
            k_pooling=int(mp.get("k_pooling", 3)),
            downscale=int(mp.get("downscale_res", 2)), match_th=0.03,
            w2c=torch.from_numpy(np.linalg.inv(c2w)).to(dev))


def insert_mismatch(st, po) -> float:
    """The share of the map's rows where two inserts differ: a row's point
    (by more than 1e-5 m), colour, id or instance id; 1.0 when the counts
    differ."""
    n_ref, n_prog = int(st.count), int(po.count)
    if n_ref != n_prog:
        return 1.0
    n = n_ref
    if n == 0:
        return 0.0
    row_bad = ((st.points[:n] - po.points[:n]).abs() > 1e-5).any(1)
    row_bad |= (st.colors[:n] != po.colors[:n]).any(1)
    row_bad |= st.point_ids[:n] != po.point_ids[:n]
    row_bad |= st.obj_ids[:n] != po.obj_ids[:n]
    return float(row_bad.float().mean())
