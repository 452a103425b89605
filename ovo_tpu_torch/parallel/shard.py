"""Point-sharded association, the instance-sharded query and the
data-parallel keyframe embedding (port of ``ovo_tpu/parallel/shard.py``).

Each rank holds a contiguous block of the map's rows, as ``P(axis)`` does in
the reference (the map itself stays replicated, see
``mapping/semantic.py``). A rank culls, projects and matches its block
through the single-device helpers (``association.match_points``,
``_vote_counts``), then makes exactly ONE ``all_reduce`` of the
(M+1, K+1) vote matrix with the matched count packed into the same int32
buffer: integer sums, exact in any order. Every rank then takes the same
mask decisions (``association.mask_decisions``) and relabels its own block
(:func:`apply_mask_decisions`); the mask-sized tail
(``association.mask_level_tail``) runs replicated. Nothing but the vote
matrix crosses ranks in the step.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..mapping.association import (_mask_slot_lookup, _vote_counts,
                                   mask_decisions, mask_level_tail,
                                   match_points)
from ..mapping.instances import InstanceStore, _scalar
from ..mapping.map_state import MapState
from .mesh import Mesh


def block_bounds(n_rows: int, mesh: Mesh, axis: str = "dp",
                 rank: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi) of ``rank``'s contiguous block of ``n_rows`` rows: blocks of
    ceil(n_rows / size) in rank order, the last one short."""
    block = -(-n_rows // mesh.size(axis))
    lo = min(mesh.index(axis, rank) * block, n_rows)
    return lo, min(lo + block, n_rows)


def _local_votes(mesh, points, obj_ids, valid, seg_map, mask_valid, depth,
                 c2w, K, *, axis, match_distance_th, M, Kcap,
                 use_depth_filter=False, rgb_depth_ratio=None, w2c=None):
    """This block's cull / project / match and its vote matrix, summed over
    ``axis`` into the exact global (M+1, Kcap+1) counts by ONE all_reduce
    (the matched count rides in the same buffer). Returns (votes_full,
    seg (N_block,), n_matched ())."""
    seg, matched = match_points(
        points, valid, seg_map, mask_valid, depth, c2w, K, w2c=w2c,
        match_distance_th=match_distance_th,
        use_depth_filter=use_depth_filter, rgb_depth_ratio=rgb_depth_ratio)
    seg_row = torch.where(seg >= 0, seg, torch.full_like(seg, M))
    vote_col = torch.where((obj_ids >= 0) & (seg >= 0),
                           obj_ids.clamp(0, Kcap - 1),
                           torch.full_like(obj_ids, Kcap))
    votes = _vote_counts(seg_row, vote_col, M, Kcap)
    buf = torch.cat([votes.reshape(-1),
                     matched.sum(dtype=torch.int32).reshape(1)])
    mesh.all_reduce(buf, axis)
    return buf[:-1].reshape(M + 1, Kcap + 1), seg, buf[-1]


@torch.no_grad()
def sharded_vote_step(mesh: Mesh, points, obj_ids, valid, seg_map, depth,
                      c2w, K, *, axis: str = "dp",
                      match_distance_th: float = 0.05, n_masks: int = 96,
                      n_instances: int = 1024):
    """Point-sharded geometric association votes: ``points`` / ``obj_ids``
    / ``valid`` are this rank's block, the frame and camera replicated.
    Returns (total (M,), assigned (M,), votes (M, K)) for the whole map and
    the block's per-point mask slot (N_block,)."""
    M, Kcap = n_masks, n_instances
    mask_valid = torch.ones(M, dtype=torch.bool, device=points.device)
    votes_full, seg, _ = _local_votes(
        mesh, points, obj_ids, valid, seg_map, mask_valid, depth, c2w, K,
        axis=axis, match_distance_th=match_distance_th, M=M, Kcap=Kcap)
    total = votes_full[:M].sum(dim=1, dtype=torch.int32)
    votes = votes_full[:M, :Kcap]
    return total, votes.sum(dim=1, dtype=torch.int32), votes, seg


@torch.no_grad()
def sharded_associate_step(mesh: Mesh, points, obj_ids, valid, seg_map,
                           mask_valid, depth, c2w, K, next_id, *,
                           axis: str = "dp", match_distance_th: float = 0.05,
                           track_th: int = 100, n_masks: int = 96,
                           n_instances: int = 1024,
                           mint_cap: Optional[int] = None,
                           use_depth_filter: bool = False,
                           rgb_depth_ratio=None, w2c=None):
    """The point-sized half of a keyframe's association over a sharded map:
    the block's votes, ONE all_reduce, the mask decisions every rank takes
    alike (minting by prefix sum over ``next_id``, the same helper as the
    single-device path), the block relabelled. ``n_instances``: the vote
    matrix's instance columns (the store's capacity, or the live-instance
    bucket); ``mint_cap``: the store's capacity when smaller columns are
    used. Returns (new obj_ids of the block, ins_of_mask (M,), n_new,
    n_dropped, unassigned_cnt (M,), n_matched)."""
    M = n_masks
    votes_full, seg, n_matched = _local_votes(
        mesh, points, obj_ids, valid, seg_map, mask_valid, depth, c2w, K,
        axis=axis, match_distance_th=match_distance_th, M=M,
        Kcap=n_instances, use_depth_filter=use_depth_filter,
        rgb_depth_ratio=rgb_depth_ratio, w2c=w2c)
    ins_of_mask, n_new, dropped, unassigned_cnt = mask_decisions(
        votes_full, mask_valid, next_id, track_th, M, n_instances,
        mint_cap=mint_cap)
    new_obj = apply_mask_decisions(obj_ids, seg, ins_of_mask)
    return new_obj, ins_of_mask, n_new, dropped, unassigned_cnt, n_matched


@torch.no_grad()
def sharded_associate_keyframe(
        mesh: Mesh, map_state: MapState, store: InstanceStore, seg_map,
        binary_maps, mask_valid, depth, c2w, K, kf_id, *, axis: str = "dp",
        match_distance_th: float = 0.05, track_th: int = 100,
        use_depth_filter: bool = True, unbounded_top_k: bool = True,
        rgb_depth_ratio=None, active_cols: Optional[int] = None, w2c=None):
    """``association.associate_keyframe`` over a point-sharded map, with
    the same inputs and (map_state, store, KeyframeMatch) outputs: this
    rank's block of rows through :func:`sharded_associate_step` (written
    back into ``map_state.obj_ids`` in place), the mask-sized tail
    replicated. The other blocks of ``map_state.obj_ids`` are left as they
    were: :func:`gather_point_blocks` brings them in."""
    M = binary_maps.shape[0]
    Kcap = store.capacity
    Kv = active_cols if active_cols is not None and active_cols < Kcap \
        else Kcap
    lo, hi = block_bounds(map_state.capacity, mesh, axis)
    dev = map_state.device
    valid = torch.arange(lo, hi, device=dev) < map_state.count
    new_obj, ins_of_mask, n_new, dropped, unassigned_cnt, n_matched = \
        sharded_associate_step(
            mesh, map_state.points[lo:hi], map_state.obj_ids[lo:hi], valid,
            seg_map, mask_valid, depth, c2w, K, store.next_id, axis=axis,
            match_distance_th=match_distance_th, track_th=track_th,
            n_masks=M, n_instances=Kv, mint_cap=Kcap,
            use_depth_filter=use_depth_filter,
            rgb_depth_ratio=rgb_depth_ratio, w2c=w2c)
    map_state.obj_ids[lo:hi] = new_obj
    store, match = mask_level_tail(
        store, ins_of_mask, n_new, dropped, unassigned_cnt, seg_map,
        binary_maps, _scalar(kf_id, dev), n_matched,
        unbounded_top_k=unbounded_top_k)
    return map_state, store, match


def gather_point_blocks(mesh: Mesh, obj_ids: torch.Tensor,
                        axis: str = "dp") -> torch.Tensor:
    """Every rank's block of ``obj_ids`` gathered into every rank's copy, in
    place (ONE all_gather)."""
    n = obj_ids.shape[0]
    lo, hi = block_bounds(n, mesh, axis)
    block = -(-n // mesh.size(axis))
    local = obj_ids.new_full((block,), -1)
    local[:hi - lo] = obj_ids[lo:hi]
    obj_ids.copy_(mesh.all_gather(local, axis)[:n])
    return obj_ids


def apply_mask_decisions(obj_ids: torch.Tensor, seg: torch.Tensor,
                         ins_of_mask: torch.Tensor) -> torch.Tensor:
    """Unassigned matched points take their mask's instance (elementwise:
    each rank relabels its own block)."""
    point_ins = _mask_slot_lookup(seg, ins_of_mask, ins_of_mask.shape[0])
    return torch.where((obj_ids < 0) & (point_ins >= 0), point_ins, obj_ids)


def sharded_similarity(mesh: Mesh, sim_fn: Callable, txt_embeds: torch.Tensor,
                       ins_descs: torch.Tensor, axis: str = "dp"
                       ) -> torch.Tensor:
    """Instance-sharded text-query similarity: the instance axis padded to
    the axis size and split in blocks, each rank's block through the
    embedder's own row-wise ``sim_fn(txt, descs) -> (n, Q)``, the rows
    gathered once. Returns (N, Q) on every rank."""
    n, d = ins_descs.shape
    size = mesh.size(axis)
    pad = (-n) % size
    if pad:
        ins_descs = torch.cat([ins_descs, ins_descs.new_zeros((pad, d))])
    b = (n + pad) // size
    i = mesh.index(axis)
    local = sim_fn(txt_embeds, ins_descs[i * b:(i + 1) * b])
    return mesh.all_gather(local, axis)[:n]


def dp_batched_embed(mesh: Mesh, embed_fn: Callable, images, masks, valid,
                     axis: str = "dp") -> torch.Tensor:
    """Replicated encoder, keyframe batch split over ``axis``: the batch
    padded to the axis size (the last keyframe repeated), each rank embeds
    its block with ``embed_fn(images, masks, valid) -> (b, M, D)``, the
    descriptors gathered once. Returns (B, M, D) on every rank."""
    b = images.shape[0]
    size = mesh.size(axis)
    pad = (-b) % size
    if pad:
        images, masks, valid = (
            torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
            for t in (images, masks, valid))
    per = (b + pad) // size
    i = mesh.index(axis)
    blk = slice(i * per, (i + 1) * per)
    local = embed_fn(images[blk], masks[blk], valid[blk])
    return mesh.all_gather(local, axis)[:b]
