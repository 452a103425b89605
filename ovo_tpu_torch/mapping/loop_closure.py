"""Semantic loop closure (port of ``ovo_tpu/mapping/loop_closure.py``).

On a SLAM big change: instances whose point support vanished are removed,
and pairs of instances that pass three gates (centroid distance, descriptor
cosine, point overlap) are fused, greedily in id order as the reference
(OVO.update_map) does.

The gates of all K x K pairs come from one pass on the device (per-instance
point counts and centroids, the normalized-descriptor gram, f32). The host
reads them once, lists the candidate pairs in ``np.argwhere`` order, and
reads once more the point overlap of every candidate pair, computed
together on the device from each instance's first ``sample`` points in
buffer order. The greedy choice then runs on the host; :func:`apply_fusion`
relabels the map and merges the store on the device, reading nothing back.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import to_device
from .instances import InstanceStore, _heap_key
from .map_state import MapState

# candidate pairs whose point overlap is computed in one batch
_PAIR_CHUNK = 64


@torch.no_grad()
def _gate_and_sample(map_state: MapState, store: InstanceStore,
                     th_centroid: float, th_cossim: float):
    """Per-instance support counts and centroids, and the candidate-pair
    gates (i < j) with the descriptors' cosine matrix."""
    K = store.capacity
    dev = map_state.device
    obj = map_state.obj_ids.long()
    ok = map_state.valid_mask() & (obj >= 0) & (obj < K)
    row = torch.where(ok, obj, torch.full_like(obj, K))
    counts = torch.zeros(K + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, row, torch.ones_like(row, dtype=torch.int32))
    sums = torch.zeros((K + 1, 3), dtype=torch.float32, device=dev)
    sums.index_add_(0, row, map_state.points)
    counts, sums = counts[:K], sums[:K]
    centroids = sums / counts.clamp_min(1)[:, None].float()

    alive = store.active & (counts > 0)
    d2 = ((centroids[:, None, :] - centroids[None, :, :]) ** 2).sum(dim=-1)
    gate_c = d2.clamp_min(0.0).sqrt() <= th_centroid

    feat = store.clip_feature
    unit = feat / torch.linalg.vector_norm(feat, dim=-1,
                                           keepdim=True).clamp_min(1e-12)
    cos = unit @ unit.T
    live = alive & store.has_clip
    ids = torch.arange(K, device=dev)
    gate = (gate_c & (cos >= th_cossim) & live[:, None] & live[None, :]
            & (ids[:, None] < ids[None, :]))
    return counts, centroids, alive, gate, cos


def _read_gates(gate: torch.Tensor, alive: torch.Tensor,
                active: torch.Tensor) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """The gates, ``alive`` and ``active`` on the host: loop closure's
    first read of the device."""
    K = alive.shape[0]
    host = torch.cat([gate.reshape(-1), alive, active]).cpu().numpy()
    return host[:K * K].reshape(K, K), host[K * K:K * K + K], host[K * K + K:]


def _read_overlaps(overlap: torch.Tensor, cos: torch.Tensor
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Each candidate pair's overlap and cosine on the host: loop closure's
    second read of the device."""
    host = torch.cat([overlap, cos]).cpu().numpy()
    return host[:len(overlap)], host[len(overlap):]


def _instance_samples(obj_ids: torch.Tensor, points: torch.Tensor,
                      ins: torch.Tensor, sample: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each id in ``ins``: the points of the first ``sample`` buffer
    rows labelled with it (over the whole buffer, as the reference samples
    its host copy), zero-padded, and their number -> ((I, S, 3), (I,))."""
    obj = obj_ids.to(torch.int32)
    order = torch.argsort(obj, stable=True)
    sorted_obj = obj[order]
    ins32 = ins.to(torch.int32)
    first = torch.searchsorted(sorted_obj, ins32)
    n = torch.searchsorted(sorted_obj, ins32, right=True) - first
    n = n.clamp_max(sample)
    s = torch.arange(sample, device=obj.device)
    take = s[None, :] < n[:, None]
    rows = order[(first[:, None] + s[None, :]).clamp_max(len(order) - 1)]
    pts = torch.where(take[:, :, None], points[rows],
                      torch.zeros((), dtype=points.dtype, device=obj.device))
    return pts, n


def _pair_overlap(p1: torch.Tensor, n1: torch.Tensor, p2: torch.Tensor,
                  n2: torch.Tensor, th_points: float) -> torch.Tensor:
    """Per pair: the fraction of p1's first n1 points within th_points of
    p2[:n2] ((P, S, 3), (P,) -> (P,) f32)."""
    S = p1.shape[1]
    d2 = ((p1[:, :, None, :] - p2[:, None, :, :]) ** 2).sum(dim=-1)
    s = torch.arange(S, device=p1.device)
    d2 = torch.where(s[None, None, :] < n2[:, None, None], d2,
                     torch.full_like(d2, float("inf")))
    mind = d2.amin(dim=2).sqrt()
    close = (mind < th_points) & (s[None, :] < n1[:, None])
    return close.float().sum(dim=1) / n1.clamp_min(1).float()


@torch.no_grad()
def semantic_loop_closure(map_state: MapState, store: InstanceStore,
                          th_centroid: float = 1.5, th_cossim: float = 0.81,
                          th_points: float = 0.1, sample: int = 512
                          ) -> Tuple[MapState, InstanceStore, Dict[int, int]]:
    """Returns (map_state, store, fused: {deleted_id: surviving_id})."""
    _, _, alive, gate, cos = _gate_and_sample(map_state, store, th_centroid,
                                              th_cossim)
    gate_np, alive_np, active_np = _read_gates(gate, alive, store.active)
    # candidate pairs i < j in id order: the reference walks its objects in
    # key order and consumes them greedily
    cand = np.argwhere(gate_np)
    fused: Dict[int, int] = {}
    if len(cand):
        dev = map_state.device
        ins, inv = np.unique(cand, return_inverse=True)
        pairs = to_device(inv.reshape(-1, 2).astype(np.int64), dev)
        pts, n = _instance_samples(map_state.obj_ids, map_state.points,
                                   to_device(ins.astype(np.int64), dev),
                                   sample)
        i_idx, j_idx = pairs[:, 0], pairs[:, 1]
        overlap = torch.cat([
            _pair_overlap(pts[i_idx[c:c + _PAIR_CHUNK]],
                          n[i_idx[c:c + _PAIR_CHUNK]],
                          pts[j_idx[c:c + _PAIR_CHUNK]],
                          n[j_idx[c:c + _PAIR_CHUNK]], th_points)
            for c in range(0, len(cand), _PAIR_CHUNK)])
        cand_d = to_device(cand.astype(np.int64), dev)
        # a candidate is alive, so it labels at least one point: no sample
        # is empty
        overlap_np, cos_np = _read_overlaps(
            overlap, cos[cand_d[:, 0], cand_d[:, 1]])
        for k, (i, j) in enumerate(cand):
            i, j = int(i), int(j)
            if i in fused or j in fused:
                continue
            p_dist = float(overlap_np[k])
            c = cos_np[k]
            if p_dist > 0.5 or (c > 0.9 and p_dist > 0.2):
                fused[j] = i  # j merges into i (i keeps iterating)

    dead = np.where(active_np & ~alive_np)[0]
    map_state, store = apply_fusion(map_state, store, fused,
                                    dead_ids=dead.tolist())
    if fused or len(dead):
        print(f"Semantic Map update: removed {len(dead)}, fused {len(fused)} "
              "instances")
    return map_state, store, fused


def fusion_remap(capacity: int, fused: Dict[int, int]) -> np.ndarray:
    """(K,) i32 id table sending each fused id to its final survivor (merge
    chains a -> b -> c followed, four steps as the reference)."""
    remap = np.arange(capacity, dtype=np.int32)
    for j, i in fused.items():
        remap[j] = i
    for _ in range(4):
        remap = remap[remap]
    return remap


@torch.no_grad()
def apply_fusion(map_state: MapState, store: InstanceStore,
                 fused: Dict[int, int], dead_ids: Sequence[int] = ()
                 ) -> Tuple[MapState, InstanceStore]:
    """Relabel the point buffer by the fusion table, merge the descriptor
    statistics and top-kf slots into each survivor, and deactivate the dead
    and the merged ids, on the device."""
    K = store.capacity
    dev = store.device
    remap = fusion_remap(K, fused)
    remap_d = to_device(remap, dev)
    obj = map_state.obj_ids
    new_obj = torch.where(obj >= 0, remap_d[obj.long().clamp(0, K - 1)], obj)
    map_state = map_state._replace(obj_ids=new_obj)

    if fused:
        src_np = np.fromiter(fused.keys(), np.int64)
        src = to_device(src_np, dev)
        dst = to_device(remap[src_np].astype(np.int64), dev)
        store = store._replace(
            desc_sum=store.desc_sum.index_add(0, dst, store.desc_sum[src]),
            desc_cnt=store.desc_cnt.index_add(0, dst, store.desc_cnt[src]),
            n_points=store.n_points.index_add(0, dst, store.n_points[src]),
            active=store.active.index_fill(0, src, False))
        # each survivor pools its top-kf slots with those of the ids it
        # absorbed and keeps the top T by (area, kf), as replaying the
        # reference's add_top_kf over the absorbed entries would
        groups: Dict[int, list] = {}
        for s in src_np.tolist():
            groups.setdefault(int(remap[s]), []).append(int(s))
        width = 1 + max(len(v) for v in groups.values())
        members = np.full((len(groups), width), K, np.int64)
        for g, (d, srcs) in enumerate(groups.items()):
            members[g, :1 + len(srcs)] = [d] + srcs
        members_d = to_device(members, dev)
        T = store.n_slots
        pad = torch.full((1, T), -1, dtype=torch.int32, device=dev)
        area = torch.cat([store.top_area, pad])[members_d].reshape(
            len(groups), width * T)
        kf = torch.cat([store.top_kf, pad])[members_d].reshape(
            len(groups), width * T)
        order = torch.sort(_heap_key(area, kf), dim=1, descending=True,
                           stable=True).indices[:, :T]
        sel_area, sel_kf = area.gather(1, order), kf.gather(1, order)
        empty = sel_area < 0
        rows = members_d[:, 0]
        top_area, top_kf = store.top_area.clone(), store.top_kf.clone()
        top_area[rows] = torch.where(empty, -1, sel_area)
        top_kf[rows] = torch.where(empty, -1, sel_kf)
        # the survivor's descriptor becomes the mean of the merged sums
        cnt = store.desc_cnt[dst].clamp_min(1)[:, None]
        clip_feature = store.clip_feature.clone()
        clip_feature[dst] = store.desc_sum[dst] / cnt
        has_clip = store.has_clip.clone()
        has_clip[dst] = has_clip[dst] | (store.desc_cnt[dst] > 0)
        store = store._replace(top_area=top_area, top_kf=top_kf,
                               clip_feature=clip_feature, has_clip=has_clip)

    if len(dead_ids):
        store = store._replace(active=store.active.index_fill(
            0, to_device(np.asarray(dead_ids, np.int64), dev), False))
    return map_state, store
