"""GT-pose point-cloud mapper backbone (port of ``ovo_tpu/slam/vanilla.py``).

Backbone interface shared by the tiers: track_camera(frame_data),
map(frame_data, c2w), get_c2w(fid), get_map(), get_kfs(), get_map_dict() /
set_map_dict(), get_cam_dict() / set_cam_dict(), update_pcd_obj_ids(state),
map_updated flag. The map is a fixed-capacity MapState on the device,
grown in power-of-2 buckets before an insert could overflow it.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .. import to_device
from ..mapping.insert_graph import CAPTURE, EAGER, InsertGraph, insert_key
from ..mapping.map_state import (MapState, from_map_dict, grow_map_state,
                                 init_map_state, map_dict, map_insert_frame)
from ..utils import trace
from ..utils.async_scalar import AsyncScalar


class VanillaMapper:
    def __init__(self, config: Dict[str, Any], cam_intrinsics,
                 device: torch.device) -> None:
        self.device = device
        self.cam_intrinsics = to_device(
            np.asarray(cam_intrinsics, np.float32), device)
        self.config = config
        mapping = config.get("mapping", {})
        self.k_pooling = int(mapping.get("k_pooling", 3))
        self.downscale = int(mapping.get("downscale_res",
                                         mapping.get("downscale_ratio", 2)))
        self.match_distance_th = 0.03  # 3 cm (vanilla_mapper.py:15)
        capacity = int(mapping.get("n_points_capacity", 2 ** 21))
        self.max_capacity = capacity
        self.bucketed = bool(mapping.get("bucketed_growth", True))
        start = min(capacity, int(mapping.get("initial_capacity", 2 ** 18)))
        self.state: MapState = init_map_state(
            start if self.bucketed else capacity, device)
        self._count_ub = 0
        self.estimated_c2ws: Dict[int, np.ndarray] = {}
        self.kfs: Dict[int, Any] = {}
        self.map_updated = False
        # fused associate+insert support: a host-side upper bound on the
        # device count feeds active_rows without a per-frame sync -- the
        # count is copied back asynchronously after each insert and
        # harvested one insert later
        self.supports_fused_insert = True
        self._n_inserts = 0
        self._count_req = None        # (AsyncScalar, n_inserts at request)
        self._count_known = (0, 0)    # (count, n_inserts it covers)
        self._last_headroom = 0
        # the insert as a replayed CUDA graph (a CUDA map only)
        self._graph = (InsertGraph(device) if device.type == "cuda"
                       else None)

    # -- tracking -------------------------------------------------------
    def track_camera(self, frame_data: List[Any]) -> None:
        frame_id, c2w = frame_data[0], frame_data[3]
        if np.isinf(c2w).sum() > 0 or np.isnan(c2w).sum() > 0:
            return
        self.estimated_c2ws[frame_id] = np.asarray(c2w, np.float32)

    def get_c2w(self, frame_id: int):
        return self.estimated_c2ws.get(frame_id)

    # -- mapping --------------------------------------------------------
    def _headroom(self, depth) -> int:
        return (depth.shape[0] * depth.shape[1]
                // max(self.downscale, 1) ** 2)

    def _pre_insert_grow(self, depth) -> None:
        """Grow BEFORE the insert could overflow, from a host-side upper
        bound on count (sum of per-frame maxima)."""
        if not self.bucketed:
            return
        self._count_ub += self._headroom(depth)
        cap = self.state.capacity
        while cap < self.max_capacity and self._count_ub > cap:
            cap = min(cap * 2, self.max_capacity)
        if cap != self.state.capacity:
            with trace.span("map_insert.grow"):
                self.state = grow_map_state(self.state, cap)
            trace.count("map_grows")
            trace.gauge("map_capacity", cap)

    def post_insert(self) -> None:
        """After an insert: harvest the PREVIOUS async count, request this
        one. Never waits on the just-dispatched insert."""
        if self._count_req is not None:
            req, n = self._count_req
            with trace.wait("insert_count"):
                self._count_known = (req.get(), n)
            trace.gauge("map_live_points", self._count_known[0])
        self._n_inserts += 1
        self._count_req = (AsyncScalar(self.state.count), self._n_inserts)

    def count_upper_bound(self) -> int:
        c, n = self._count_known
        return c + (self._n_inserts - n) * self._last_headroom

    def fused_insert_args(self, frame_data: List[Any]) -> Dict[str, Any]:
        """Pre-insert growth + the insert-side kwargs of the fused
        associate+insert call. Colors are sliced to the insert grid on the
        host; active_rows is the power-of-2 bucket covering
        count_upper_bound() (>= the device count by construction)."""
        image, depth = frame_data[1], frame_data[2]
        self._last_headroom = self._headroom(depth)
        self._pre_insert_grow(depth)
        ds = self.downscale
        colors = (np.ascontiguousarray(np.asarray(image)[::ds, ::ds])
                  if ds > 1 else np.asarray(image))
        ub = max(self.count_upper_bound(), 1)
        ar = 1 << (ub - 1).bit_length()
        if ar >= self.state.capacity:
            ar = None
        trace.gauge("map_active_rows", ar or self.state.capacity)
        return dict(colors=colors, insert_match_th=self.match_distance_th,
                    k_pooling=self.k_pooling, downscale=ds, active_rows=ar)

    def map(self, frame_data: List[Any], c2w) -> None:
        """Insert a frame. On a CUDA map the insert is replayed as one CUDA
        graph where its key repeats (``mapping/insert_graph.py``)."""
        with trace.span("map_insert", frame_data[0]):
            image, depth = frame_data[1], frame_data[2]
            self._last_headroom = self._headroom(depth)
            self._pre_insert_grow(depth)
            c2w = np.asarray(c2w, np.float32)
            w2c = np.linalg.inv(c2w).astype(np.float32)
            kw = dict(k_pooling=self.k_pooling, downscale=self.downscale,
                      match_th=self.match_distance_th)
            g = self._graph
            key = None if g is None else insert_key(
                self.state, image, depth, self.cam_intrinsics, **kw)
            action = EAGER if g is None else g.plan(key)
            if action == EAGER:
                if g is not None:
                    trace.count("map_insert.eager")
                dev = self.device
                with trace.span("map_insert.upload"):
                    frame = (to_device(image, dev),
                             to_device(depth, dev, torch.float32),
                             to_device(c2w, dev))
                    w2c = to_device(w2c, dev)
                with trace.span("map_insert.dispatch"):
                    self.state = map_insert_frame(
                        self.state, *frame, self.cam_intrinsics, w2c=w2c,
                        **kw)
            else:
                with trace.span("map_insert.upload"):
                    g.stage(self.state, image, depth, c2w, w2c)
                if action == CAPTURE:
                    with trace.span("map_insert.capture"):
                        g.capture(key, map_insert_frame, self.state,
                                  self.cam_intrinsics, **kw)
                    trace.count("map_insert.graph_captures")
                with trace.span("map_insert.dispatch"):
                    self.state = g.replay()
                trace.count("map_insert.graph_replays")
            self.post_insert()

    # -- accessors ------------------------------------------------------
    def get_map(self) -> MapState:
        return self.state

    def set_map(self, state: MapState) -> None:
        self.state = state

    def get_kfs(self):
        return self.kfs

    def update_pcd_obj_ids(self, state_or_ids) -> None:
        if isinstance(state_or_ids, MapState):
            self.state = state_or_ids
        else:
            self.state = self.state._replace(obj_ids=to_device(
                np.asarray(state_or_ids, np.int32), self.device))

    def get_pcd_colors(self) -> np.ndarray:
        n = int(self.state.count)
        return self.state.colors[:n].cpu().numpy()

    # -- checkpointing (reference key layout) ---------------------------
    def get_map_dict(self) -> Dict[str, Any]:
        return map_dict(self.state)

    def set_map_dict(self, d: Dict[str, Any]) -> None:
        n = int(np.asarray(d["xyz"]).shape[0])
        cap = self.state.capacity
        while cap < n:
            cap = min(cap * 2, max(self.max_capacity, n))
        self.state = from_map_dict(d, capacity=cap, device=self.device)
        self._count_ub = n
        self._n_inserts = 0
        self._count_req = None
        self._count_known = (n, 0)

    def get_cam_dict(self) -> Dict[int, np.ndarray]:
        return {k: np.asarray(v) for k, v in self.estimated_c2ws.items()}

    def set_cam_dict(self, cam_dict: Dict[Any, Any]) -> None:
        self.estimated_c2ws = {int(k): np.asarray(v, np.float32)
                               for k, v in cam_dict.items()}
