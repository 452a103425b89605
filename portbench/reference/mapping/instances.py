"""Fixed-capacity 3D instance store as a struct of tensors (port of
``ovo_tpu/mapping/instances.py``).

Per-instance descriptor fusion state (streaming sum/count for
``avg_pooling``, per-view slots for the medoid fusions), the top-k
keyframes by mask area as (K, T) area/kf arrays, and the id counter.

Scatter discipline, as in the reference: batch entries are keyed by
instance id; invalid entries are routed to a sentinel row == capacity that
is sliced off (JAX's ``mode="drop"``), and gathers clamp their index (JAX's
out-of-bounds gather rule). Nothing here synchronizes with the host. The
functions return a new store; tensors they do not touch are shared.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# heap keys: area * 2^20 + kf reproduces heapq's (area, kf_id) tuple order
_KF_BITS = 20


def _heap_key(area: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    key = area.long() * (1 << _KF_BITS) + kf.long()
    return torch.where(area < 0, torch.full_like(key, -(1 << 62)), key)


@dataclasses.dataclass
class InstanceStore:
    active: torch.Tensor        # (K,) bool
    clip_feature: torch.Tensor  # (K, D) f32 fused descriptor
    has_clip: torch.Tensor      # (K,) bool
    desc_sum: torch.Tensor      # (K, D) f32 streaming sum
    desc_cnt: torch.Tensor      # (K,) i32 fused views
    n_points: torch.Tensor      # (K,) i32 points ever matched
    top_area: torch.Tensor      # (K, T) i32, -1 empty
    top_kf: torch.Tensor        # (K, T) i32, -1 empty
    slot_desc: torch.Tensor     # (K, T, D) f32 (medoid fusion) or (K, 1, D)
    slot_valid: torch.Tensor    # (K, T) bool or (K, 1)
    next_id: torch.Tensor       # () i32

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    @property
    def n_slots(self) -> int:
        return self.top_area.shape[1]

    @property
    def device(self) -> torch.device:
        return self.active.device

    def _replace(self, **kw) -> "InstanceStore":
        return dataclasses.replace(self, **kw)


def init_instance_store(n_instances: int, clip_dim: int, n_slots: int = 16,
                        store_slot_descs: bool = False,
                        device="cpu") -> InstanceStore:
    K, T, D = n_instances, n_slots, clip_dim
    dev = torch.device(device)

    def z(shape, dtype, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    Ts = T if store_slot_descs else 1
    return InstanceStore(
        active=z((K,), torch.bool, False),
        clip_feature=z((K, D), torch.float32),
        has_clip=z((K,), torch.bool, False),
        desc_sum=z((K, D), torch.float32),
        desc_cnt=z((K,), torch.int32),
        n_points=z((K,), torch.int32),
        top_area=z((K, T), torch.int32, -1),
        top_kf=z((K, T), torch.int32, -1),
        slot_desc=z((K, Ts, D), torch.float32),
        slot_valid=z((K, Ts), torch.bool, False),
        next_id=z((), torch.int32),
    )


def grow_instance_store(store: InstanceStore, new_capacity: int
                        ) -> InstanceStore:
    """Re-pad every per-instance buffer to a larger capacity; ids stay."""
    if new_capacity <= store.capacity:
        return store
    pad = new_capacity - store.capacity

    def grow(name):
        buf = getattr(store, name)
        fill = -1 if name in ("top_area", "top_kf") else 0
        return torch.cat([buf, buf.new_full((pad,) + tuple(buf.shape[1:]),
                                            fill)])

    return InstanceStore(next_id=store.next_id, **{
        f.name: grow(f.name) for f in dataclasses.fields(InstanceStore)
        if f.name != "next_id"})


def _scalar(x, device: torch.device) -> torch.Tensor:
    """A () int32 tensor on ``device``; a Python int is filled in on the
    device (no host-to-device copy, which would sync the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=device)


def _rows(store: InstanceStore, ins_ids: torch.Tensor, valid: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scatter_rows, gather_rows, effective_valid), int64 indices."""
    ids = ins_ids.long()
    v = valid & (ids >= 0) & (ids < store.capacity)
    scatter = torch.where(v, ids, torch.full_like(ids, store.capacity))
    gather = ids.clamp(0, store.capacity - 1)
    return scatter, gather, v


def _ext(buf: torch.Tensor) -> torch.Tensor:
    """buf with one sentinel row appended (dropped writes land there)."""
    return torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))])


def _scatter_set(buf, index, vals):
    ext = _ext(buf)
    ext.index_put_(index, vals.to(buf.dtype))
    return ext[:-1]


def _scatter_add(buf, rows, vals):
    ext = _ext(buf)
    ext.index_add_(0, rows, vals.to(buf.dtype))
    return ext[:-1]


# ---------------------------------------------------------------------------
# Top-k keyframe bookkeeping
# ---------------------------------------------------------------------------

def add_top_kf(store: InstanceStore, ins_ids: torch.Tensor, kf_id,
               areas: torch.Tensor, valid: torch.Tensor) -> InstanceStore:
    """Vectorized heap update: bump a slot the kf already holds when the
    area grew, else replace the minimum (area, kf) slot when the new entry
    compares greater."""
    scatter, gather, v = _rows(store, ins_ids, valid)
    kf = _scalar(kf_id, store.device)
    g_area = store.top_area[gather]
    g_kf = store.top_kf[gather]
    keys = _heap_key(g_area, g_kf)
    min_idx = keys.argmin(dim=1)
    min_key = keys.gather(1, min_idx[:, None])[:, 0]
    exists = g_kf == kf
    has_kf = exists.any(dim=1)
    exist_idx = exists.to(torch.uint8).argmax(dim=1)
    exist_area = g_area.gather(1, exist_idx[:, None])[:, 0]

    kf_full = kf.expand_as(areas).to(torch.int32)
    new_key = _heap_key(areas, kf_full)
    bump = has_kf & (areas > exist_area)
    enter = (~has_kf) & (new_key > min_key)
    col = torch.where(has_kf, exist_idx, min_idx)
    write = v & (bump | enter)
    row_w = torch.where(write, scatter, torch.full_like(scatter,
                                                        store.capacity))
    top_area = _scatter_set(store.top_area, (row_w, col), areas)
    top_kf = _scatter_set(store.top_kf, (row_w, col), kf_full)

    # replacing a slot invalidates any stored per-view descriptor there
    sv_col = col.clamp_max(store.slot_valid.shape[1] - 1)
    row_inv = torch.where(v & enter, scatter,
                          torch.full_like(scatter, store.capacity))
    slot_valid = _scatter_set(store.slot_valid, (row_inv, sv_col),
                              torch.zeros_like(v))
    return store._replace(top_area=top_area, top_kf=top_kf,
                          slot_valid=slot_valid)


def is_top_kf(store: InstanceStore, ins_ids: torch.Tensor, kf_id
              ) -> torch.Tensor:
    """(B,) bool: is ``kf_id`` among each instance's top slots."""
    gather = ins_ids.long().clamp(0, store.capacity - 1)
    kf = _scalar(kf_id, store.device)
    return (store.top_kf[gather] == kf).any(dim=1) & (ins_ids >= 0)


# ---------------------------------------------------------------------------
# Descriptor fusion
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_descriptors(store: InstanceStore, ins_ids: torch.Tensor,
                       descs: torch.Tensor, kf_id, valid: torch.Tensor, *,
                       fusion: str = "avg_pooling") -> InstanceStore:
    """Fold one keyframe's per-instance descriptors into the store.

    avg_pooling: running mean. l1_medoid / cossim_medoid: descriptors also
    land in the kf's slot and the fused feature is the medoid over valid
    slots."""
    scatter, gather, v = _rows(store, ins_ids, valid)
    descs = descs.float()
    desc_sum = _scatter_add(store.desc_sum, scatter, descs)
    desc_cnt = _scatter_add(store.desc_cnt, scatter,
                            torch.ones_like(scatter, dtype=torch.int32))
    store = store._replace(desc_sum=desc_sum, desc_cnt=desc_cnt)

    if fusion == "avg_pooling":
        cnt = store.desc_cnt[gather].clamp_min(1)[:, None]
        fused = store.desc_sum[gather] / cnt
        clip_feature = _scatter_set(store.clip_feature, (scatter,), fused)
        has_clip = _scatter_set(store.has_clip, (scatter,),
                                torch.ones_like(v))
        return store._replace(clip_feature=clip_feature, has_clip=has_clip)

    T = store.n_slots
    if store.slot_desc.shape[1] != T:
        raise ValueError("medoid fusion requires store_slot_descs=True")
    kf = _scalar(kf_id, store.device)
    in_slot = store.top_kf[gather] == kf                   # (B, T)
    slot_idx = in_slot.to(torch.uint8).argmax(dim=1)
    v2 = v & in_slot.any(dim=1)
    row2 = torch.where(v2, scatter, torch.full_like(scatter, store.capacity))
    slot_desc = _scatter_set(store.slot_desc, (row2, slot_idx), descs)
    slot_valid = _scatter_set(store.slot_valid, (row2, slot_idx),
                              torch.ones_like(v2))
    store = store._replace(slot_desc=slot_desc, slot_valid=slot_valid)

    fused, ok = _medoid(store.slot_desc[gather], store.slot_valid[gather],
                        fusion)
    row3 = torch.where(v & ok, scatter,
                       torch.full_like(scatter, store.capacity))
    clip_feature = _scatter_set(store.clip_feature, (row3,), fused)
    has_clip = _scatter_set(store.has_clip, (row3,), torch.ones_like(v))
    return store._replace(clip_feature=clip_feature, has_clip=has_clip)


@torch.no_grad()
def drop_keyframe_descriptors(store: InstanceStore, ins_ids: torch.Tensor,
                              descs: torch.Tensor, valid: torch.Tensor,
                              culled_kfs: torch.Tensor, *,
                              fusion: str = "avg_pooling") -> InstanceStore:
    """Take culled keyframes' contributions out of the store and re-fuse
    every instance from what survives.

    ins_ids / descs / valid: the per-(kf, instance) descriptor rows of all
      culled keyframes ((B,), (B, D), (B,)); invalid rows are ignored.
    culled_kfs: (C,) i32 culled keyframe ids, padded with -2 (which matches
      no slot: -1 marks an empty one).
    """
    scatter, _, v = _rows(store, ins_ids, valid)
    desc_sum = _scatter_add(store.desc_sum, scatter,
                            torch.where(v[:, None], -descs.float(), 0.0))
    desc_cnt = _scatter_add(store.desc_cnt, scatter,
                            torch.where(v, -1, 0).to(torch.int32)).clamp_min(0)
    # a culled keyframe leaves every instance's top-kf slots, whether or not
    # it computed a descriptor
    hit = (store.top_kf[:, :, None] == culled_kfs.to(torch.int32)[
        None, None, :]).any(dim=-1)
    store = store._replace(
        desc_sum=desc_sum, desc_cnt=desc_cnt,
        top_area=torch.where(hit, -1, store.top_area),
        top_kf=torch.where(hit, -1, store.top_kf),
        slot_valid=store.slot_valid & ~hit[:, :store.slot_valid.shape[1]])
    if fusion == "avg_pooling":
        fused = store.desc_sum / store.desc_cnt.clamp_min(1)[:, None]
        has = store.desc_cnt > 0
        return store._replace(clip_feature=torch.where(has[:, None], fused, 0.0),
                              has_clip=store.has_clip & has)
    fused, ok = _medoid(store.slot_desc, store.slot_valid, fusion)
    return store._replace(clip_feature=torch.where(ok[:, None], fused, 0.0),
                          has_clip=store.has_clip & ok)


def _medoid(descs: torch.Tensor, valid: torch.Tensor, fusion: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched medoid over valid rows of (B, T, D): l1_medoid minimizes the
    summed L1 distance, cossim_medoid maximizes the summed cosine
    similarity. Returns (fused (B, D), any_valid (B,))."""
    vf = valid.to(descs.dtype)
    if fusion == "l1_medoid":
        d = (descs[:, :, None, :] - descs[:, None, :, :]).abs().sum(dim=-1)
        d = d * vf[:, None, :]
        score = torch.where(valid, -d.sum(dim=2),
                            torch.full_like(vf, float("-inf")))
    elif fusion == "cossim_medoid":
        norm = torch.linalg.vector_norm(descs, dim=-1, keepdim=True)
        unit = descs / norm.clamp_min(1e-12)
        sim = unit @ unit.transpose(1, 2)
        sim = sim * vf[:, None, :]
        score = torch.where(valid, sim.sum(dim=2),
                            torch.full_like(vf, float("-inf")))
    else:
        raise NotImplementedError(fusion)
    idx = score.argmax(dim=1)
    fused = descs.gather(1, idx[:, None, None].expand(-1, 1,
                                                      descs.shape[-1]))[:, 0]
    return fused, valid.any(dim=1)


# ---------------------------------------------------------------------------
# Instance minting / bookkeeping
# ---------------------------------------------------------------------------

def mint_instances(store: InstanceStore, n_new: torch.Tensor
                   ) -> InstanceStore:
    """Activate ids [next_id, next_id + n_new)."""
    ids = torch.arange(store.capacity, device=store.device)
    newly = (ids >= store.next_id) & (ids < store.next_id + n_new)
    return store._replace(
        active=store.active | newly,
        next_id=(store.next_id + n_new).clamp_max(store.capacity).to(
            torch.int32))


def add_matched_points(store: InstanceStore, ins_ids: torch.Tensor,
                       counts: torch.Tensor, valid: torch.Tensor
                       ) -> InstanceStore:
    scatter, _, _ = _rows(store, ins_ids, valid)
    return store._replace(
        n_points=_scatter_add(store.n_points, scatter, counts))
