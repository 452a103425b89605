"""Per-keyframe instance association (port of
``ovo_tpu/mapping/association.py``).

frustum cull -> project map points -> depth match -> per-mask majority vote
(an (M+1, K+1) count matrix over mask slot x instance id; argmax tie-break
== torch.mode's lowest-value rule) -> new-instance minting by prefix sum ->
point id write-back -> per-instance mask OR-fusion -> top-k keyframe update.

Masks are padded to ``M`` slots with validity flags, instances live in a
static id space of ``K``, and nothing synchronizes with the host. The JAX
package's one-hot matmul forms (a TPU gather/scatter workaround) become
plain index ops here with bit-equal integer results. The map's ``obj_ids``
and the appended rows are written IN PLACE (see ``map_state``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import geometry as geo
from ..ops import segment_mxu
from ..utils import trace
from . import instances as inst
from .instances import InstanceStore, _scalar
from .map_state import MapState, _scatter_append, strided_unproject


def _validated_seg_image(seg_map: torch.Tensor, mask_valid: torch.Tensor,
                         M: int) -> torch.Tensor:
    """Per-pixel seg id if in range and its slot is valid, else -1 (f32)."""
    ar = torch.arange(M, dtype=torch.int32, device=seg_map.device)
    tbl = torch.cat([torch.where(mask_valid, ar, torch.full_like(ar, -1)),
                     ar.new_full((1,), -1)])
    idx = torch.where((seg_map >= 0) & (seg_map < M), seg_map,
                      torch.full_like(seg_map, M))
    out = segment_mxu.table_lookup_int(idx.reshape(-1), tbl)
    return out.reshape(seg_map.shape).float()


def _mask_slot_lookup(seg: torch.Tensor, slot_values: torch.Tensor,
                      M: int) -> torch.Tensor:
    """out[i] = slot_values[seg[i]] if seg[i] in [0, M) else -1."""
    tbl = torch.cat([slot_values.to(torch.int32),
                     slot_values.new_full((1,), -1, dtype=torch.int32)])
    idx = torch.where((seg >= 0) & (seg < M), seg, torch.full_like(seg, M))
    return segment_mxu.table_lookup_int(idx, tbl)


def _vote_counts(seg_row: torch.Tensor, vote_col: torch.Tensor, M: int,
                 Kcap: int) -> torch.Tensor:
    """(N,) slot ids in [0, M] x (N,) instance columns in [0, Kcap] ->
    (M+1, Kcap+1) int32 count matrix."""
    flat = seg_row.long() * (Kcap + 1) + vote_col.long()
    out = torch.zeros((M + 1) * (Kcap + 1), dtype=torch.int32,
                      device=seg_row.device)
    out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return out.reshape(M + 1, Kcap + 1)


def mask_decisions(votes_full: torch.Tensor, mask_valid: torch.Tensor,
                   next_id: torch.Tensor, track_th: int, M: int, Kcap: int,
                   mint_cap: Optional[int] = None):
    """Majority vote, track / new gating at ``track_th``, new-id minting by
    prefix sum over ``next_id``, capacity clipping. Returns (ins_of_mask
    (M,), n_new (), n_dropped (), unassigned_cnt (M,))."""
    total = votes_full[:M].sum(dim=1, dtype=torch.int32)
    votes = votes_full[:M, :Kcap]
    assigned_cnt = votes.sum(dim=1, dtype=torch.int32)
    unassigned_cnt = total - assigned_cnt
    mode_id = votes.argmax(dim=1).to(torch.int32)          # ties -> lowest id

    observed = mask_valid & (total > track_th)
    case_track = observed & (assigned_cnt > track_th)
    case_new = observed & ~case_track & (unassigned_cnt > track_th)
    new_rank = case_new.to(torch.int32).cumsum(0, dtype=torch.int32) - 1
    new_id = next_id + new_rank
    cap_ok = new_id < (Kcap if mint_cap is None else mint_cap)
    dropped = (case_new & ~cap_ok).sum(dtype=torch.int32)
    case_new = case_new & cap_ok
    minus1 = torch.full_like(mode_id, -1)
    ins_of_mask = torch.where(case_track, mode_id,
                              torch.where(case_new, new_id.to(torch.int32),
                                          minus1))
    n_new = case_new.sum(dtype=torch.int32)
    return ins_of_mask, n_new, dropped, unassigned_cnt


@dataclasses.dataclass
class KeyframeMatch:
    """Per-keyframe association output (padded to M mask slots)."""
    ins_ids: torch.Tensor     # (M,) i32 instance id per kept slot, -1 else
    fused_maps: torch.Tensor  # (M, H, W) bool OR-fused binary masks
    keep: torch.Tensor        # (M,) bool
    areas: torch.Tensor       # (M,) i32
    n_new: torch.Tensor       # () i32
    n_matched: torch.Tensor   # () i32
    n_dropped_masks: torch.Tensor  # () i32


def mask_level_tail(store: InstanceStore, ins_of_mask, n_new, dropped,
                    unassigned_cnt, seg_map, binary_maps, kf_id, n_matched,
                    *, unbounded_top_k: bool = True
                    ) -> Tuple[InstanceStore, KeyframeMatch]:
    """Minting, per-instance mask OR-fusion, areas, top-k update, and the
    KeyframeMatch assembly."""
    M = binary_maps.shape[0]
    dev = binary_maps.device
    store = inst.mint_instances(store, n_new)

    has_ins = ins_of_mask >= 0
    same = ((ins_of_mask[:, None] == ins_of_mask[None, :])
            & has_ins[:, None] & has_ins[None, :])
    first_idx = same.to(torch.uint8).argmax(dim=1)         # min slot w/ id
    keep_slot = has_ins & (first_idx == torch.arange(M, device=dev))
    group_size = same.sum(dim=1)

    seg_dest = torch.where(has_ins, first_idx, torch.full_like(first_idx, M))
    fused_maps = segment_mxu.segment_or(seg_dest, binary_maps, M)

    seg_flat = seg_map.reshape(-1)
    seg_area = segment_mxu.histogram(
        torch.where(seg_flat >= 0, seg_flat, torch.full_like(seg_flat, M)),
        M).to(torch.int32)
    fused_area = fused_maps.sum(dim=(1, 2), dtype=torch.int32)
    areas = torch.where(group_size > 1, fused_area, seg_area)

    store = inst.add_top_kf(store, ins_of_mask, kf_id, areas, keep_slot)
    if unbounded_top_k:
        keep = keep_slot
    else:
        keep = keep_slot & inst.is_top_kf(store, ins_of_mask, kf_id)

    grp_unassigned = inst._scatter_add(
        torch.zeros(M, dtype=torch.int32, device=dev), seg_dest,
        unassigned_cnt)
    store = inst.add_matched_points(store, ins_of_mask, grp_unassigned,
                                    keep_slot)
    out = KeyframeMatch(
        ins_ids=torch.where(keep, ins_of_mask, torch.full_like(ins_of_mask,
                                                               -1)),
        fused_maps=fused_maps, keep=keep, areas=areas, n_new=n_new,
        n_matched=n_matched, n_dropped_masks=dropped)
    return store, out


def _pixel_lookup(uc, vc, seg_map, rgb_depth_ratio):
    """RGB-resolution flat pixel index of depth-resolution pixels."""
    r_h, r_w, crop_edge = rgb_depth_ratio
    u2 = ((uc + crop_edge).float() * r_w).to(torch.int32)
    v2 = ((vc + crop_edge).float() * r_h).to(torch.int32)
    Hr, Wr = seg_map.shape
    return (v2.clamp(0, Hr - 1) * Wr + u2.clamp(0, Wr - 1)).long()


def _active(map_state: MapState, active_rows: Optional[int]):
    AR = (active_rows if active_rows is not None
          and active_rows < map_state.capacity else None)
    if AR is None:
        return None, map_state.points, map_state.obj_ids, \
            map_state.valid_mask()
    return (AR, map_state.points[:AR], map_state.obj_ids[:AR],
            torch.arange(AR, device=map_state.device) < map_state.count)


def _project(points, K, w2c, h, w):
    uv, z = geo.project_points(points, K, w2c)
    in_plane = ((uv[:, 0] >= 0) & (uv[:, 0] < w)
                & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    uc = uv[:, 0].clamp(0, w - 1)
    vc = uv[:, 1].clamp(0, h - 1)
    return z, in_plane, uc, vc


def _votes_and_writeback(map_state, store, seg, obj, AR, mask_valid,
                         track_th, M, active_cols, extra_unassigned=None):
    Kcap = store.capacity
    Kv = (active_cols if active_cols is not None and active_cols < Kcap
          else Kcap)
    seg_row = torch.where(seg >= 0, seg, torch.full_like(seg, M))
    assigned = obj >= 0
    vote_col = torch.where(assigned & (seg >= 0), obj.clamp(0, Kv - 1),
                           torch.full_like(obj, Kv))
    votes_full = _vote_counts(seg_row, vote_col, M, Kv)
    if extra_unassigned is not None:
        votes_full[:, Kv] += extra_unassigned
    ins_of_mask, n_new, dropped, unassigned_cnt = mask_decisions(
        votes_full, mask_valid, store.next_id, track_th, M, Kv,
        mint_cap=Kcap)
    point_ins = _mask_slot_lookup(seg, ins_of_mask, M)
    update = (~assigned) & (point_ins >= 0)
    new_obj = torch.where(update, point_ins, obj)
    if AR is None:
        map_state.obj_ids.copy_(new_obj)
    else:
        map_state.obj_ids[:AR] = new_obj
    return ins_of_mask, n_new, dropped, unassigned_cnt


def match_points(points: torch.Tensor, row_valid: torch.Tensor,
                 seg_map: torch.Tensor, mask_valid: torch.Tensor,
                 depth: torch.Tensor, c2w: torch.Tensor, K: torch.Tensor, *,
                 w2c: Optional[torch.Tensor] = None,
                 match_distance_th: float = 0.05,
                 use_depth_filter: bool = True,
                 rgb_depth_ratio: Optional[Tuple[float, float, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The point-sized half of the association: frustum cull, projection,
    depth match and the validated mask slot under each matched point.
    Row-wise, so a block of the map's rows gives that block's answers (the
    point-sharded step, ``parallel/shard.py``). Returns (seg (N,) i32 in
    [-1, M), matched (N,) bool)."""
    M = mask_valid.shape[0]
    seg_img = _validated_seg_image(seg_map, mask_valid, M)
    corners = geo.compute_camera_frustum_corners(depth, c2w, K)
    in_frustum = geo.points_in_frustum(points, corners, valid=row_valid)
    depth_m = geo.depth_filter(depth) if use_depth_filter else depth

    h, w = depth.shape
    z, in_plane, uc, vc = _project(points, K, geo.inverse_pose(c2w, w2c),
                                   h, w)
    flat_px = (vc * w + uc).long()
    if rgb_depth_ratio is None:
        g = geo.packed_pixel_table(depth_m, seg_img)[flat_px]
        d_m, seg_pt = g[:, 0], g[:, 1].to(torch.int32)
    else:
        d_m = geo.packed_pixel_table(depth_m)[flat_px, 0]
        seg_pt = geo.packed_pixel_table(seg_img)[
            _pixel_lookup(uc, vc, seg_map, rgb_depth_ratio),
            0].to(torch.int32)

    matched = (in_frustum & in_plane & ((z - d_m).abs() < match_distance_th)
               & (d_m != 0))
    return torch.where(matched, seg_pt, torch.full_like(seg_pt, -1)), matched


@torch.no_grad()
def associate_keyframe(
    map_state: MapState, store: InstanceStore,
    seg_map: torch.Tensor,      # (Hr, Wr) i32 in [-1, M)
    binary_maps: torch.Tensor,  # (M, Hr, Wr) bool
    mask_valid: torch.Tensor,   # (M,) bool
    depth: torch.Tensor,        # (h, w) f32
    c2w: torch.Tensor,          # (4, 4)
    K: torch.Tensor,            # (3, 3) depth-resolution intrinsics
    kf_id,                      # () i32 tensor or int
    *, match_distance_th: float = 0.05, track_th: int = 100,
    use_depth_filter: bool = True, unbounded_top_k: bool = True,
    rgb_depth_ratio: Optional[Tuple[float, float, int]] = None,
    active_rows: Optional[int] = None, active_cols: Optional[int] = None,
    w2c: Optional[torch.Tensor] = None,
) -> Tuple[MapState, InstanceStore, KeyframeMatch]:
    """Per-keyframe association. ``active_rows`` bounds the rows the
    per-point ops touch (caller contract: active_rows >= count);
    ``active_cols`` bounds the vote matrix's instance axis (caller
    contract: active_cols >= store.next_id). ``w2c``: inv(c2w) when the
    caller has it (a small-matrix inverse on the card may synchronize)."""
    M = binary_maps.shape[0]
    with trace.span("association.match"):
        AR, points, obj, row_valid = _active(map_state, active_rows)
        seg, matched = match_points(
            points, row_valid, seg_map, mask_valid, depth, c2w, K, w2c=w2c,
            match_distance_th=match_distance_th,
            use_depth_filter=use_depth_filter,
            rgb_depth_ratio=rgb_depth_ratio)
    with trace.span("association.votes"):
        ins_of_mask, n_new, dropped, unassigned_cnt = _votes_and_writeback(
            map_state, store, seg, obj, AR, mask_valid, track_th, M,
            active_cols)
    with trace.span("association.tail"):
        store, out = mask_level_tail(
            store, ins_of_mask, n_new, dropped, unassigned_cnt, seg_map,
            binary_maps, _scalar(kf_id, depth.device),
            matched.sum(dtype=torch.int32), unbounded_top_k=unbounded_top_k)
    return map_state, store, out


@torch.no_grad()
def associate_and_insert_keyframe(
    map_state: MapState, store: InstanceStore, seg_map: torch.Tensor,
    binary_maps: torch.Tensor, mask_valid: torch.Tensor,
    image: torch.Tensor,   # (h, w, 3) u8, or (h//ds, w//ds, 3) pre-subsampled
    depth: torch.Tensor, c2w: torch.Tensor, K: torch.Tensor, kf_id, *,
    match_distance_th: float = 0.05, track_th: int = 100,
    use_depth_filter: bool = True, unbounded_top_k: bool = True,
    rgb_depth_ratio: Optional[Tuple[float, float, int]] = None,
    insert_match_th: float = 0.03, k_pooling: int = 3, downscale: int = 2,
    active_rows: Optional[int] = None, active_cols: Optional[int] = None,
    w2c: Optional[torch.Tensor] = None,
) -> Tuple[MapState, InstanceStore, KeyframeMatch]:
    """Fused association + vanilla map insert: exactly the two-step
    ``map_insert_frame`` -> ``associate_keyframe`` flow (a keyframe's own
    fresh points join its votes and receive ids), sharing one projection
    and one pixel gather of the map. The insert decision is taken against
    the PRE-insert map; the inserted points, all unassigned, add their
    matched rows to the per-mask unassigned counts."""
    M = binary_maps.shape[0]
    AR, points, obj, row_valid = _active(map_state, active_rows)
    h, w = depth.shape
    dev = depth.device

    depth_m = geo.depth_filter(depth) if use_depth_filter else depth
    seg_img = _validated_seg_image(seg_map, mask_valid, M)

    corners = geo.compute_camera_frustum_corners(depth, c2w, K)
    in_frustum = geo.points_in_frustum(points, corners, valid=row_valid)
    w2c = geo.inverse_pose(c2w, w2c)
    z, in_plane, uc, vc = _project(points, K, w2c, h, w)
    flat_px = (vc * w + uc).long()

    if rgb_depth_ratio is None:
        packed = geo.packed_pixel_table(depth, depth_m, seg_img)
        g = packed[flat_px]
        d_raw, d_m, seg_pt = g[:, 0], g[:, 1], g[:, 2].to(torch.int32)
    else:
        packed = geo.packed_pixel_table(depth, depth_m)
        g = packed[flat_px]
        d_raw, d_m = g[:, 0], g[:, 1]
        seg_tbl = geo.packed_pixel_table(seg_img)
        seg_pt = seg_tbl[_pixel_lookup(uc, vc, seg_map,
                                       rgb_depth_ratio), 0].to(torch.int32)

    base = in_frustum & in_plane
    matched = base & ((z - d_m).abs() < match_distance_th) & (d_m != 0)
    ins_matched = base & ((z - d_raw).abs() < insert_match_th) & (d_raw != 0)
    seg = torch.where(matched, seg_pt, torch.full_like(seg_pt, -1))

    # insert decision against the PRE-insert map
    hits = geo.hit_mask_scatter(flat_px, ins_matched, h * w).reshape(h, w)
    have_map = map_state.count > 0
    if downscale > 1:
        depth_ds = geo.subsample2d(depth, downscale)
        image_ds = image if image.shape[0] == h // downscale \
            else geo.subsample2d(image, downscale)
        ins_mask = torch.where(
            have_map,
            geo.max_pool_erode((depth > 0) & ~hits, k_pooling,
                               stride=downscale),
            depth_ds > 0)
        new_pts = strided_unproject(depth_ds, K, c2w, downscale)
    else:
        image_ds = image
        ins_mask = torch.where(
            have_map, geo.max_pool_erode((depth > 0) & ~hits, k_pooling),
            depth > 0)
        new_pts = geo.unproject_depth(depth, K, c2w)

    # self-votes of the freshly inserted points (all unassigned)
    flat_ins = ins_mask.reshape(-1)
    rank = flat_ins.to(torch.int32).cumsum(0, dtype=torch.int32) - 1
    inserted = flat_ins & (map_state.count + rank < map_state.capacity)
    in_frustum_n = geo.points_in_frustum(new_pts, corners, valid=inserted)
    z_n, in_plane_n, ucn, vcn = _project(new_pts, K, w2c, h, w)
    if rgb_depth_ratio is None:
        # the new points unproject from this camera's strided pixel grid, so
        # their projected pixels ARE the grid pixels (>= 0.49 px guard band):
        # read the pixel tables as a strided subsample
        ds = max(downscale, 1)
        d_m_n = geo.subsample2d(depth_m, ds).reshape(-1)
        seg_pt_n = geo.subsample2d(seg_img, ds).reshape(-1).to(torch.int32)
    else:
        d_m_n = packed[(vcn * w + ucn).long()][:, 1]
        seg_pt_n = seg_tbl[_pixel_lookup(ucn, vcn, seg_map,
                                         rgb_depth_ratio), 0].to(torch.int32)
    matched_n = (in_frustum_n & in_plane_n
                 & ((z_n - d_m_n).abs() < match_distance_th) & (d_m_n != 0))
    seg_n = torch.where(matched_n, seg_pt_n, torch.full_like(seg_pt_n, -1))
    hist_n = segment_mxu.histogram(
        torch.where(seg_n >= 0, seg_n, torch.full_like(seg_n, M)),
        M + 1).to(torch.int32)

    ins_of_mask, n_new, dropped, unassigned_cnt = _votes_and_writeback(
        map_state, store, seg, obj, AR, mask_valid, track_th, M, active_cols,
        extra_unassigned=hist_n)
    obj_n = _mask_slot_lookup(seg_n, ins_of_mask, M)
    n_matched = matched.sum(dtype=torch.int32) + matched_n.sum(
        dtype=torch.int32)
    store, out = mask_level_tail(
        store, ins_of_mask, n_new, dropped, unassigned_cnt, seg_map,
        binary_maps, _scalar(kf_id, dev), n_matched,
        unbounded_top_k=unbounded_top_k)
    map_state = _scatter_append(map_state, new_pts, image_ds.reshape(-1, 3),
                                flat_ins, obj_vals=obj_n)
    return map_state, store, out
