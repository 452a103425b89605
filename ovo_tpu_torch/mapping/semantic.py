"""Semantic mapping core, online half (port of
``ovo_tpu/mapping/semantic.py``).

Host code sequences the per-keyframe device work -- masks, the fused
association + map insert, and the deferred-CLIP keyframe queue -- and never
waits on the device in the hot loop: the instance store's ``next_id`` and
the masks' validity reach the host through asynchronous copies harvested
one keyframe later (``utils/async_scalar.py``); growth checks and the
``active_cols`` bucket need only upper bounds.

Text queries and classification (``query``, ``classify_instances``) run
after mapping, or on a mapper restored from a checkpoint (``eval=True``,
``restore_dict``; ``debug_info=True`` restores the debug records as well).
``debug_info`` keeps the per-keyframe association records and instance maps
for the checkpoint's debug layout (a host read per keyframe, as in the JAX
package).

SAM micro-batching (``sam.batch`` B > 1, the reference's perf knob): B
segment keyframes are buffered, segmented in one batched mask-source call
(``get_masks_batch``) and then associated strictly in order; the deferred
descriptors are popped B at a time through the embedder's
``embed_masks_batch``. A flush reads each keyframe's mask validity on the
host (the reference's skip-on-empty); it is the only host read of that
path's frame loop.

Multi-process paths (``parallel`` keys, ``parallel/shard.py``), over the
world's ranks all on the dp axis (the default process group when one is
initialised, else a world of one, with trivial collectives):
``point_shard`` associates each rank's block of the map's rows with one
``all_reduce`` of the votes, then gathers the relabelled blocks once a
keyframe (the map stays replicated on every rank); ``dp_embed`` splits a
micro-batch of keyframes over the ranks and gathers the descriptors;
``shard_query`` splits the instances of a text query.

Semantic loop closure (``update_map``, called by the pipeline when a SLAM
backbone reports a big change): the deferred descriptors are drained, the
descriptors of keyframes the backbone culled are taken out of the store,
and overlapping instances are fused (``mapping/loop_closure.py``, two host
reads of the device); the per-keyframe records follow the merges.

Pluggable backends (duck-typed):
  mask_source.get_masks(image (H, W, 3) u8 numpy, frame_id) ->
      (seg_map (H, W) i32, binary_maps (M, H, W) bool, valid (M,) bool)
  embedder.clip_dim
  embedder.embed_masks(image, binary_maps, valid) -> (M, D) f32
  embedder.embed_text(texts) -> (T, D) unit vectors (queries only)
  embedder.similarity(txt (Q, D), descriptors (N, D)) -> (N, Q)
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device, to_device
from ..utils.async_scalar import AsyncScalar
from . import instances as inst
from .association import associate_and_insert_keyframe, associate_keyframe
from .instances import InstanceStore, init_instance_store
from .loop_closure import fusion_remap, semantic_loop_closure
from .map_state import MapState

_MEDOID_FUSIONS = ("l1_medoid", "cossim_medoid")


def instance_pixel_map(fused_maps: torch.Tensor, ins_ids: torch.Tensor,
                       keep: torch.Tensor) -> torch.Tensor:
    """(M, H, W) fused masks + (M,) instance ids -> (H, W) i32 instance
    map, -1 where no kept mask covers a pixel; a later slot overwrites an
    earlier one where masks overlap."""
    ids = torch.where(keep & (ins_ids >= 0), ins_ids,
                      torch.full_like(ins_ids, -1))
    cover = fused_maps & (ids >= 0)[:, None, None]
    M = fused_maps.shape[0]
    last = (M - 1) - torch.argmax(cover.flip(0).to(torch.uint8), dim=0)
    return torch.where(cover.any(dim=0), ids[last],
                       torch.full_like(last, -1)).to(torch.int32)


def keyframe_has_mask(valid: torch.Tensor) -> bool:
    """Whether a buffered keyframe has a valid mask: the micro-batch
    flush's skip-on-empty, a host read per keyframe (the only one its frame
    loop makes)."""
    return bool(valid.any())


class SemanticMapper:
    """Instance store + keyframe queue; drives the per-keyframe device
    work. Mirrors OVO's online surface: detect_and_track_objects,
    compute/complete_semantic_info, capture_dict."""

    def __init__(self, config: Dict[str, Any], logger=None,
                 scene_name: Optional[str] = None,
                 cam_intrinsics: Optional[np.ndarray] = None,
                 eval: bool = False, mask_source=None, embedder=None,
                 device="cuda") -> None:
        if not eval and cam_intrinsics is None:
            raise ValueError("camera intrinsics required for reconstruction")
        self.device = resolve_device(device)
        self.config = config
        self.logger = logger
        self.cam_intrinsics = None if cam_intrinsics is None else to_device(
            np.asarray(cam_intrinsics, np.float32), self.device)
        self.mask_source = mask_source
        self.embedder = embedder

        clip_cfg = config.get("clip", {})
        self.n_top_views = int(clip_cfg.get("k_top_views", 0))
        self.fusion = clip_cfg.get("fusion", "l1_medoid")
        self.clip_dim = (embedder.clip_dim if embedder is not None
                         else int(clip_cfg.get("clip_dim", 1024)))

        caps = config.get("capacity", {})
        self.n_instances = int(caps.get("n_instances", 1024))
        self.grow_instances = bool(caps.get("grow_instances", True))
        n_slots_cfg = int(caps.get("top_k_slots", 16))
        self.unbounded_top_k = (self.n_top_views <= 0
                                or self.n_top_views > n_slots_cfg)
        n_slots = (n_slots_cfg if self.unbounded_top_k
                   else max(self.n_top_views, 1))
        self.store: InstanceStore = init_instance_store(
            self.n_instances, self.clip_dim, n_slots=n_slots,
            store_slot_descs=self.fusion in _MEDOID_FUSIONS,
            device=self.device)

        self.match_distance_th = float(config.get("match_distance_th", 0.05))
        self.track_th = int(config.get("track_th", 100))
        self.use_depth_filter = bool(config.get("depth_filter", False))
        self.kf_queue_delay = int(config.get("kf_queue_delay", 0))
        self.th_centroid = float(config.get("th_centroid", 1.5))
        self.th_cossim = float(config.get("th_cossim", 0.81))
        self.th_points = float(config.get("th_points", 0.1))
        self.log = bool(config.get("log", False))

        self.keyframes_queue: deque = deque()
        self.kf_id = 0
        # device-side count of masks lost to instance-capacity overflow
        # (zero while grow_instances is on); read only on demand
        self._dropped_dev = torch.zeros((), dtype=torch.int32,
                                        device=self.device)
        # async next_id mirror: requested after each association, harvested
        # one keyframe later; in between the bound grows by M per keyframe
        self._nid_reqs: deque = deque()           # (AsyncScalar, kf_at)
        self._nid_known = (0, 0)                  # (next_id, kf_at)
        # deferred empty-mask warnings, checked one keyframe late
        self._valid_req: List[tuple] = []         # (frame_id, AsyncScalar)
        self.frame_ids: List[int] = []
        # per-(kf, instance) descriptor record, device-resident
        self.kf_descriptors: Dict[int, tuple] = {}

        # debug_info: per keyframe the matched ids and mask areas, and the
        # per-pixel instance map, as host arrays for the debug checkpoint
        self.debug_info = bool(config.get("debug_info", False))
        self.kf_records: Dict[int, tuple] = {}   # kf -> (ins_ids, areas)
        self.kf_ins_maps: Dict[int, np.ndarray] = {}
        # SAM micro-batching: (frame_id, image, depth, ratio, c2w) buffered
        # until sam_batch keyframes can be segmented together
        self.sam_batch = int(config.get("sam", {}).get("batch", 1))
        self._pending: List[tuple] = []
        par_cfg = config.get("parallel", {}) or {}
        self.point_shard = bool(par_cfg.get("point_shard", False))
        self.shard_query = bool(par_cfg.get("shard_query", False))
        self.dp_embed = bool(par_cfg.get("dp_embed", False))
        self._mesh = None

    @property
    def mesh(self):
        """The world's ranks, all on dp (built on first use: every rank of
        the world must reach it)."""
        if self._mesh is None:
            from ..parallel.mesh import make_mesh, world_size

            self._mesh = make_mesh((world_size(), 1))
            self._mesh.check_device(self.device)
        return self._mesh

    # ------------------------------------------------------------------
    # Per-keyframe association
    # ------------------------------------------------------------------

    def detect_and_track_objects(self, frame_data, map_state: MapState,
                                 c2w, insert: Optional[Dict[str, Any]] = None
                                 ) -> Optional[MapState]:
        """frame_data: (frame_id, image, depth, rgb_depth_ratio) with host
        (numpy) image and depth. ``insert``: when set, the keyframe's vanilla
        map insert fuses into the association (keys: colors,
        insert_match_th, k_pooling, downscale, active_rows)."""
        frame_id, image, depth, rgb_depth_ratio = frame_data
        if self.sam_batch > 1 and hasattr(self.mask_source,
                                          "get_masks_batch"):
            if insert is not None:
                raise ValueError("the fused map insert needs sam.batch == 1")
            self._pending.append((frame_id, image, depth, rgb_depth_ratio,
                                  np.asarray(c2w)))
            if len(self._pending) < self.sam_batch:
                return None
            return self.flush_segmentation(map_state)
        t0 = time.time()
        seg_map, binary_maps, mask_valid = self.mask_source.get_masks(
            image, frame_id)
        if seg_map is None:
            print(f"No mask segmented in {frame_id}!")
            return None
        if self.log or self.debug_info:
            # log and debug runs accept syncs: the exact skip-on-empty
            if not bool(mask_valid.any()):
                print(f"No mask segmented in {frame_id}!")
                return None
        else:
            # hot path: association with zero valid masks is a no-op on
            # instance state, so proceed and warn one keyframe late
            self._valid_req.append((frame_id, AsyncScalar(mask_valid.any())))
        # upload the frame once: the deferred embedder reads it later
        image_dev = to_device(image, self.device)
        t_sam = time.time() - t0
        return self._associate(frame_id, image_dev, depth, rgb_depth_ratio,
                               c2w, seg_map, binary_maps, mask_valid,
                               map_state, t_sam, insert=insert)

    def _nid_upper_bound(self, m_masks: int) -> int:
        """Host-known bound >= store.next_id with no sync: the last
        harvested value + m_masks per keyframe since."""
        nid, kf_at = self._nid_known
        return nid + m_masks * (self.kf_id - kf_at)

    def _drain_async(self) -> None:
        """Harvest async values of PREVIOUS keyframes; the newest next_id
        request stays pending (its chain was just dispatched)."""
        while len(self._nid_reqs) > 1:
            req, kf_at = self._nid_reqs.popleft()
            if kf_at > self._nid_known[1]:
                self._nid_known = (req.get(), kf_at)
        for frame_id, req in self._valid_req:
            if not req.get():
                print(f"No mask segmented in {frame_id}!")
        self._valid_req = []

    def flush_segmentation(self, map_state: MapState) -> Optional[MapState]:
        """Segment every buffered keyframe in one batched mask-source call,
        then associate each in order against the evolving map. Returns the
        last new map state (None if nothing was associated)."""
        if not self._pending:
            return None
        pending, self._pending = self._pending, []
        t0 = time.time()
        images = np.stack([p[1] for p in pending])
        seg_b, bmaps_b, valid_b = self.mask_source.get_masks_batch(
            images, [p[0] for p in pending])
        # one upload of the frames: the deferred embedder reads them
        images_dev = to_device(images, self.device)
        t_sam = time.time() - t0
        out = None
        for j, (frame_id, _, depth, ratio, c2w) in enumerate(pending):
            if not keyframe_has_mask(valid_b[j]):
                print(f"No mask segmented in {frame_id}!")
                continue
            new_state = self._associate(
                frame_id, images_dev[j], depth, ratio, c2w, seg_b[j],
                bmaps_b[j], valid_b[j], map_state if out is None else out,
                t_sam / len(pending))
            if new_state is not None:
                out = new_state
        return out

    def _associate(self, frame_id, image, depth, rgb_depth_ratio, c2w,
                   seg_map, binary_maps, mask_valid, map_state, t_sam,
                   insert: Optional[Dict[str, Any]] = None
                   ) -> Optional[MapState]:
        M = binary_maps.shape[0]
        dev = self.device
        if self.log and self.logger is not None:
            last_id = int(self.store.next_id)     # exact, for the stats
            nid_ub = last_id
            self._nid_reqs.clear()
            self._nid_known = (last_id, self.kf_id)
        else:
            last_id = None
            nid_ub = self._nid_upper_bound(M)
        # a keyframe mints at most M instances: grow before it could overflow
        if self.grow_instances and nid_ub + M > self.store.capacity:
            new_cap = max(self.store.capacity * 2,
                          1 << (nid_ub + M - 1).bit_length())
            print(f"[semantic] growing instance store "
                  f"{self.store.capacity} -> {new_cap} (next_id<={nid_ub})")
            self.store = inst.grow_instance_store(self.store, new_cap)
        t0 = time.time()
        ratio = tuple(rgb_depth_ratio) if len(rgb_depth_ratio) else None
        # vote-matrix column bucket: next_id + M always fits
        a_cols = 1 << max(nid_ub + M - 1, 127).bit_length()
        a_cols = a_cols if a_cols < self.store.capacity else None
        depth_d = to_device(depth, dev, torch.float32)
        c2w_np = np.asarray(c2w, np.float32)
        c2w_d = to_device(c2w_np, dev)
        kf = torch.full((), self.kf_id, dtype=torch.int32, device=dev)
        kw = dict(w2c=to_device(np.linalg.inv(c2w_np).astype(np.float32),
                                dev),
                  match_distance_th=self.match_distance_th,
                  track_th=self.track_th,
                  use_depth_filter=self.use_depth_filter,
                  unbounded_top_k=self.unbounded_top_k,
                  rgb_depth_ratio=ratio, active_cols=a_cols)
        if insert is not None:
            if self.point_shard:
                raise ValueError("the fused insert is single-device "
                                 "(point_shard associates in two steps)")
            map_state, self.store, match = associate_and_insert_keyframe(
                map_state, self.store, seg_map, binary_maps, mask_valid,
                to_device(insert["colors"], dev), depth_d, c2w_d,
                self.cam_intrinsics, kf,
                insert_match_th=insert["insert_match_th"],
                k_pooling=insert["k_pooling"], downscale=insert["downscale"],
                active_rows=insert.get("active_rows"), **kw)
        elif self.point_shard:
            from ..parallel.shard import (gather_point_blocks,
                                          sharded_associate_keyframe)

            map_state, self.store, match = sharded_associate_keyframe(
                self.mesh, map_state, self.store, seg_map, binary_maps,
                mask_valid, depth_d, c2w_d, self.cam_intrinsics, kf, **kw)
            # each rank relabelled its own block of rows; the map stays
            # replicated, so the blocks are gathered once a keyframe: the
            # explicit form of the reshard GSPMD inserts in the reference
            # before the next insert program
            gather_point_blocks(self.mesh, map_state.obj_ids)
        else:
            map_state, self.store, match = associate_keyframe(
                map_state, self.store, seg_map, binary_maps, mask_valid,
                depth_d, c2w_d, self.cam_intrinsics, kf, **kw)

        self._dropped_dev = self._dropped_dev + match.n_dropped_masks
        self._nid_reqs.append((AsyncScalar(self.store.next_id), self.kf_id))
        self.keyframes_queue.append(
            dict(ins_ids=match.ins_ids, keep=match.keep,
                 fused_maps=match.fused_maps, image=image, kf_id=self.kf_id))
        self.frame_ids.append(frame_id)
        if self.debug_info:
            self.kf_records[self.kf_id] = (match.ins_ids.cpu().numpy(),
                                           match.areas.cpu().numpy())
            self.kf_ins_maps[self.kf_id] = instance_pixel_map(
                match.fused_maps, match.ins_ids, match.keep).cpu().numpy()
        self.kf_id += 1

        if self.log and self.logger is not None:
            n_matched = int(match.n_matched)
            stats = {
                "frame_id": frame_id,
                "n_obj": [int(self.store.next_id) - last_id],
                "n_matches": n_matched,
                "t_sam": round(t_sam, 2),
                "t_obj": round(time.time() - t0, 3),
            }
            dropped = int(match.n_dropped_masks)
            if dropped:
                stats["n_dropped_masks"] = dropped
                print(f"WARNING: {dropped} masks dropped at instance "
                      f"capacity {self.store.capacity} in frame {frame_id}")
            self.logger.log_ovo_stats(stats, print_output=True)
        self._drain_async()
        return map_state

    def n_dropped_masks_total(self) -> int:
        """Masks ever lost to instance-capacity overflow (one device read)."""
        return int(self._dropped_dev)

    # ------------------------------------------------------------------
    # Deferred CLIP extraction
    # ------------------------------------------------------------------

    def compute_semantic_info(self) -> None:
        """Pop keyframes once the queue is deeper than ``kf_queue_delay``:
        one per segment step, or, micro-batched, up to ``sam.batch`` at a
        time through the batched embedder."""
        step = max(self.sam_batch, 1)
        n = 0
        while len(self.keyframes_queue) > self.kf_queue_delay and n < step:
            take = min(step, len(self.keyframes_queue) - self.kf_queue_delay)
            self._compute_semantic_info(take)
            n += take

    def complete_semantic_info(self) -> None:
        while self.keyframes_queue:
            self._compute_semantic_info(
                min(max(self.sam_batch, 1), len(self.keyframes_queue)))

    def _compute_semantic_info(self, take: int = 1) -> None:
        kfs = [self.keyframes_queue.popleft() for _ in range(take)]
        kf_ts = [torch.full((), kf["kf_id"], dtype=torch.int32,
                            device=self.device) for kf in kfs]
        keeps = []
        for kf, kf_t in zip(kfs, kf_ts):
            keep = kf["keep"]
            if not self.unbounded_top_k:
                # the kf may have left an instance's top-k during the delay
                keep = keep & inst.is_top_kf(self.store, kf["ins_ids"], kf_t)
            keeps.append(keep)
        if self.debug_info or self.log or not self.unbounded_top_k:
            # debug and log runs and top-k gating keep the exact
            # skip-on-empty check
            any_keep = [bool(k.any()) for k in keeps]
            if not any(any_keep):
                return
        else:
            # hot path: embed optimistically -- keep=False rows are dropped
            # by update_descriptors, so an all-empty keyframe wastes one
            # embed
            any_keep = [True] * len(keeps)
        t0 = time.time()
        if (len(kfs) > 1 and all(any_keep)
                and hasattr(self.embedder, "embed_masks_batch")):
            batch = (torch.stack([kf["image"] for kf in kfs]),
                     torch.stack([kf["fused_maps"] for kf in kfs]),
                     torch.stack(keeps))
            descs_list = (self._dp_embed_batch(*batch) if self.dp_embed
                          else self.embedder.embed_masks_batch(*batch))
        else:
            descs_list = [
                self.embedder.embed_masks(kf["image"], kf["fused_maps"], k)
                if ok else None
                for kf, k, ok in zip(kfs, keeps, any_keep)]
        t_clip = time.time() - t0
        t0 = time.time()
        for kf, kf_t, keep, ok, descs in zip(kfs, kf_ts, keeps, any_keep,
                                             descs_list):
            if not ok:
                continue
            descs32 = descs.float()
            self.store = inst.update_descriptors(
                self.store, kf["ins_ids"], descs32, kf_t, keep,
                fusion=self.fusion)
            self.kf_descriptors[kf["kf_id"]] = (kf["ins_ids"], descs32, keep)
        if self.log and self.logger is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.logger.log_ovo_stats({
                "frame_id": self.frame_ids[kfs[-1]["kf_id"]],
                "t_clip": round(t_clip, 2),
                "t_up": round(time.time() - t0, 3),
            }, print_output=True)

    def _dp_embed_batch(self, imgs, maps, keepb) -> torch.Tensor:
        """Data-parallel keyframe embedding: the batch padded to the
        world's size, each rank's block through the replicated embedder,
        the descriptors gathered (``parallel.shard.dp_batched_embed``)."""
        from ..parallel.shard import dp_batched_embed

        dev = self.device
        return dp_batched_embed(self.mesh, self.embedder.embed_masks_batch,
                                to_device(imgs, dev), to_device(maps, dev),
                                to_device(keepb, dev))

    # ------------------------------------------------------------------
    # Loop closure
    # ------------------------------------------------------------------

    def update_map(self, map_state: MapState, kfs=None) -> MapState:
        """Semantic loop-closure update: drain the deferred descriptors,
        take out those of keyframes the SLAM backbone culled (``kfs``: the
        surviving dataset frame ids), then fuse overlapping instances."""
        flushed = self.flush_segmentation(map_state)
        if flushed is not None:
            map_state = flushed
        self.complete_semantic_info()
        if kfs is not None:
            surviving = set(kfs)
            self.drop_keyframes([k for k in range(self.kf_id)
                                 if self.frame_ids[k] not in surviving])
        map_state, self.store, fused = semantic_loop_closure(
            map_state, self.store, self.th_centroid, self.th_cossim,
            self.th_points)
        if fused:
            self._remap_kf_descriptors(fused)
        return map_state

    def drop_keyframes(self, culled_kf_ids: Sequence[int]) -> None:
        """Remove culled keyframes' descriptors and top-kf slots and re-fuse
        every instance."""
        if not culled_kf_ids:
            return
        dev = self.device
        recs = [self.kf_descriptors.pop(k) for k in culled_kf_ids
                if k in self.kf_descriptors]
        if recs:
            ids = torch.cat([r[0] for r in recs])
            descs = torch.cat([r[1] for r in recs])
            keep = torch.cat([r[2] for r in recs])
        else:
            ids = torch.zeros((1,), dtype=torch.int32, device=dev)
            descs = torch.zeros((1, self.clip_dim), dtype=torch.float32,
                                device=dev)
            keep = torch.zeros((1,), dtype=torch.bool, device=dev)
        self.store = inst.drop_keyframe_descriptors(
            self.store, ids, descs, keep,
            to_device(np.asarray(culled_kf_ids, np.int32), dev),
            fusion=self.fusion)

    def _remap_kf_descriptors(self, fused: Dict[int, int]) -> None:
        """Point the per-keyframe descriptor rows (and the debug records) of
        merged instances at their survivor, so that a later keyframe cull
        subtracts from the right row. The instance-map snapshots stay as
        recorded, as in the reference."""
        K = self.store.capacity
        remap = fusion_remap(K, fused)
        remap_d = to_device(remap, self.device)
        for k, (ids, descs, keep) in list(self.kf_descriptors.items()):
            new_ids = torch.where(ids >= 0,
                                  remap_d[ids.long().clamp(0, K - 1)], ids)
            self.kf_descriptors[k] = (new_ids, descs, keep)
        for k, (ids, areas) in list(self.kf_records.items()):
            new_ids = np.where(ids >= 0,
                               remap[np.clip(ids, 0, len(remap) - 1)], ids)
            self.kf_records[k] = (new_ids, areas)

    def restore_dict(self, scene_dict: Dict[str, Any],
                     debug_info: bool = False) -> None:
        """Consume a reference-layout checkpoint dict (numpy leaves): the
        active ids and fused descriptors, legacy ``default_<id>_*`` keys
        included; the store grows past ``n_instances`` to the largest id.
        ``debug_info`` also restores the debug records: ``frame_ids`` and
        ``kf_id``, the per-keyframe instance maps and association records,
        point counts, the bounded top-k heaps, and the per-(kf, instance)
        descriptors with the (sum, count) fusion state they imply."""
        ids = np.asarray(scene_dict["ins_3d_ids"]).astype(np.int64)
        if len(ids) and ids.max() >= self.n_instances:
            self.store = init_instance_store(
                int(ids.max()) + 1, self.clip_dim,
                n_slots=self.store.n_slots,
                store_slot_descs=self.fusion in _MEDOID_FUSIONS,
                device=self.device)

        def get(i, field):
            v = scene_dict.get(f"ins3d_{i}_{field}")
            if v is None:
                v = scene_dict.get(f"default_{i}_{field}")
            return v

        K = self.store.capacity
        active = np.zeros(K, bool)
        feats = np.zeros((K, self.clip_dim), np.float32)
        has = np.zeros(K, bool)
        n_points = np.zeros(K, np.int32)
        for i in ids:
            active[i] = True
            f = get(i, "clip_feature")
            if f is not None:
                feats[i] = np.asarray(f, np.float32).reshape(-1)[
                    :self.clip_dim]
                has[i] = True
        desc_sum = feats.copy()
        desc_cnt = has.astype(np.int32)
        dev = self.device
        tops = {}
        if debug_info:
            desc_sum[:], desc_cnt[:] = 0.0, 0
            self._restore_debug(scene_dict, ids, get, n_points, desc_sum,
                                desc_cnt, tops)
            # an instance with a fused feature but no per-kf clips counts
            # its feature as one view, so later keyframe drops stay defined
            orphan = (desc_cnt == 0) & has
            desc_sum[orphan] = feats[orphan]
            desc_cnt[orphan] = 1
        next_id = int(ids.max()) + 1 if len(ids) else 0
        repl = {}
        if tops:
            ta = self.store.top_area.cpu().numpy()
            tk = self.store.top_kf.cpu().numpy()
            for i, pairs in tops.items():
                ta[i, :len(pairs)] = pairs[:, 0]
                tk[i, :len(pairs)] = pairs[:, 1]
            repl = dict(top_area=torch.from_numpy(ta).to(dev),
                        top_kf=torch.from_numpy(tk).to(dev))
        self.store = self.store._replace(
            active=torch.from_numpy(active).to(dev),
            clip_feature=torch.from_numpy(feats).to(dev),
            has_clip=torch.from_numpy(has).to(dev),
            desc_sum=torch.from_numpy(desc_sum).to(dev),
            desc_cnt=torch.from_numpy(desc_cnt).to(dev),
            n_points=torch.from_numpy(n_points).to(dev),
            next_id=torch.full((), next_id, dtype=torch.int32, device=dev),
            **repl)
        # the host's next_id bound restarts from the restored value
        self._nid_reqs.clear()
        self._nid_known = (next_id, self.kf_id)

    def _restore_debug(self, scene_dict, ids, get, n_points, desc_sum,
                       desc_cnt, tops) -> None:
        """The debug half of :meth:`restore_dict` (the reference's order,
        ``ovo_tpu/mapping/semantic.py:758-829``): fills the mapper's
        records, and ``n_points``, ``desc_sum``, ``desc_cnt`` and ``tops``
        (instance -> its heap's (area, kf) pairs) in place."""
        self.frame_ids = [int(x) for x in
                          np.asarray(scene_dict["frame_id"]).ravel()]
        self.kf_id = len(self.frame_ids)
        ins_map = scene_dict.get("ins_map")
        self.kf_ins_maps = {}
        if ins_map is not None and len(np.asarray(ins_map)):
            arr = np.asarray(ins_map)
            for k in range(min(len(arr), self.kf_id)):
                self.kf_ins_maps[k] = arr[k]
        rec: Dict[int, Dict[int, int]] = {}
        for i in ids:
            i = int(i)
            kfs, top = get(i, "keyframes_ids"), get(i, "top_kfs")
            areas_of = {}
            if top is not None:
                for area, kf in np.asarray(top).reshape(-1, 2):
                    areas_of[int(kf)] = int(area)
            if kfs is not None:
                for kf in np.asarray(kfs).ravel():
                    rec.setdefault(int(kf), {})[i] = areas_of.get(int(kf), 0)
            pts = get(i, "points_ids")
            if pts is not None:
                n_points[i] = len(np.asarray(pts).ravel())
            if top is not None and not self.unbounded_top_k:
                pairs = np.asarray(top).reshape(-1, 2).astype(np.int64)
                order = np.lexsort((pairs[:, 1], pairs[:, 0]))
                tops[i] = pairs[order][-self.store.n_slots:]
        self.kf_records = {
            kf: (np.fromiter(a.keys(), np.int32, len(a)),
                 np.fromiter(a.values(), np.int32, len(a)))
            for kf, a in rec.items()}
        self.kf_descriptors = {}
        dev = self.device
        for kf in range(self.kf_id):
            d_ids, d_descs = [], []
            for i in ids:
                d = scene_dict.get(f"kf_{kf}_ins3d_{int(i)}_clips")
                if d is not None:
                    d = np.asarray(d, np.float32).reshape(-1)[:self.clip_dim]
                    d_ids.append(int(i))
                    d_descs.append(d)
                    desc_sum[int(i)] += d
                    desc_cnt[int(i)] += 1
            if d_ids:
                self.kf_descriptors[kf] = (
                    torch.tensor(d_ids, dtype=torch.int32, device=dev),
                    torch.from_numpy(np.stack(d_descs)).to(dev),
                    torch.ones(len(d_ids), dtype=torch.bool, device=dev))

    # ------------------------------------------------------------------
    # Query / classification (after mapping: host reads are fine here)
    # ------------------------------------------------------------------

    def active_ids(self) -> np.ndarray:
        return np.where(self.store.active.cpu().numpy())[0]

    def get_objs_clips(self) -> torch.Tensor:
        ids = torch.as_tensor(self.active_ids(), dtype=torch.long,
                              device=self.device)
        return self.store.clip_feature[ids]

    def query(self, queries: Sequence[str],
              templates: Sequence[str] = ("{}",)) -> np.ndarray:
        """(n_instances, n_queries) similarity map, instance rows in
        active-id order. Each query is embedded on its own: the mean of its
        template embeddings, normalized."""
        if len(self.active_ids()) == 0:
            raise ValueError("No 3D instances to query!")
        obj_clips = self.get_objs_clips()
        if isinstance(templates, str):
            templates = [templates]
        txt = []
        for q in queries:
            mean = self.embedder.embed_text(
                [t.format(q) for t in templates]).float().mean(dim=0)
            txt.append(mean / torch.linalg.vector_norm(mean).clamp_min(1e-12))
        txt = torch.stack(txt)
        if self.shard_query:
            from ..parallel.shard import sharded_similarity

            sim = sharded_similarity(self.mesh, self.embedder.similarity,
                                     txt, obj_clips)
        else:
            sim = self.embedder.similarity(txt, obj_clips)
        return sim.cpu().numpy()

    def classify_instances(self, classes: Sequence[str],
                           template="This is a photo of a {}",
                           th: float = 0.0) -> Dict[str, np.ndarray]:
        """Per active instance the best class index (-1 where its similarity
        is at most ``th``), its similarity (0 there) and the instance id."""
        sim = self.query(classes, template
                         if isinstance(template, (list, tuple))
                         else [template])
        cls = sim.argmax(axis=1)
        conf = sim[np.arange(len(cls)), cls]
        cls = np.where(conf <= th, -1, cls)
        conf = np.where(conf <= th, 0.0, conf)
        return {"classes": cls, "conf": conf, "ids": self.active_ids()}

    # ------------------------------------------------------------------
    # Checkpointing (the reference's key layout)
    # ------------------------------------------------------------------

    def capture_dict(self, debug_info: bool = False,
                     map_dict: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """Reference-layout checkpoint dict: ``ins_3d_ids`` plus, per active
        instance, ``ins3d_<id>_clip_feature`` and ``..._clip_feature_kf``.
        With ``debug_info`` also, per instance, ``ins3d_<id>_keyframes_ids``
        (the keyframes it matched), ``..._points_ids`` (its points in
        ``map_dict``) and ``..._top_kfs`` ((area, kf) pairs in heap order),
        plus ``frame_id``, the stacked ``ins_map`` snapshots and the
        per-(kf, instance) ``kf_<k>_ins3d_<i>_clips`` descriptors (the JAX
        package's layout)."""
        ids = self.active_ids()
        out: Dict[str, Any] = {"ins_3d_ids": np.asarray(ids)}
        feats = self.store.clip_feature.cpu().numpy()
        has = self.store.has_clip.cpu().numpy()
        for i in ids:
            out[f"ins3d_{i}_clip_feature"] = feats[i] if has[i] else None
            out[f"ins3d_{i}_clip_feature_kf"] = 0 if has[i] else None
        if not debug_info:
            return out

        out["frame_id"] = np.asarray(self.frame_ids)
        kfs_of: Dict[int, list] = {int(i): [] for i in ids}
        tops_of: Dict[int, list] = {int(i): [] for i in ids}
        for kf in sorted(self.kf_records):
            rec_ids, rec_areas = self.kf_records[kf]
            for j in np.nonzero(rec_ids >= 0)[0]:
                i = int(rec_ids[j])
                if i in kfs_of:
                    kfs_of[i].append(kf)
                    tops_of[i].append((int(rec_areas[j]), kf))
        bounded = not self.unbounded_top_k
        top_area = self.store.top_area.cpu().numpy() if bounded else None
        top_kf = self.store.top_kf.cpu().numpy() if bounded else None
        pts_ids = pts_obj = None
        if map_dict is not None:
            pts_ids = np.asarray(map_dict["ids"])
            pts_obj = np.asarray(map_dict["obj_ids"])
        for i in ids:
            i = int(i)
            out[f"ins3d_{i}_keyframes_ids"] = np.asarray(kfs_of[i], np.int64)
            out[f"ins3d_{i}_points_ids"] = (
                pts_ids[pts_obj == i] if pts_ids is not None
                else np.zeros((0,), np.int64))
            if bounded:
                vs = top_area[i] >= 0
                pairs = np.stack([top_area[i][vs], top_kf[i][vs]],
                                 axis=1).astype(np.int64)
                order = np.lexsort((pairs[:, 1], pairs[:, 0]))
                out[f"ins3d_{i}_top_kfs"] = pairs[order]
            else:
                out[f"ins3d_{i}_top_kfs"] = np.asarray(
                    sorted(tops_of[i]), np.int64).reshape(-1, 2)
        out["ins_map"] = (np.stack([self.kf_ins_maps[k]
                                    for k in sorted(self.kf_ins_maps)])
                          if self.kf_ins_maps
                          else np.zeros((0, 1, 1), np.int32))
        for kf, (d_ids, d_descs, d_keep) in self.kf_descriptors.items():
            d_ids_np = d_ids.cpu().numpy()
            d_keep_np = d_keep.cpu().numpy()
            d_descs_np = d_descs.cpu().numpy()
            for j in np.nonzero(d_keep_np & (d_ids_np >= 0))[0]:
                out[f"kf_{kf}_ins3d_{int(d_ids_np[j])}_clips"] = \
                    d_descs_np[j]
        return out
