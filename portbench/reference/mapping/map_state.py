"""Fixed-capacity device point map + the GT-pose ("vanilla") insert step
(port of ``ovo_tpu/mapping/map_state.py``).

The map lives in preallocated buffers of ``capacity`` rows with a device
``count``. Appends write the new rows at ``count`` in row-major order and
drop overflow past capacity. Unlike the JAX package (immutable arrays,
donated buffers), inserts here UPDATE THE STATE'S BUFFERS IN PLACE -- the
map is the largest allocation of the run and a copy per frame would buy
nothing -- and return a state object that shares them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import geometry as geo


@dataclasses.dataclass
class MapState:
    points: torch.Tensor         # (N, 3) f32 world coordinates
    point_ids: torch.Tensor      # (N,) i32 stable ids
    obj_ids: torch.Tensor        # (N,) i32 instance id per point, -1 = none
    colors: torch.Tensor         # (N, 3) u8
    count: torch.Tensor          # () i32 number of valid entries
    next_point_id: torch.Tensor  # () i32

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.count

    def _replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)


def init_map_state(n_points: int, device="cpu") -> MapState:
    dev = torch.device(device)
    return MapState(
        points=torch.zeros((n_points, 3), dtype=torch.float32, device=dev),
        point_ids=torch.full((n_points,), -1, dtype=torch.int32, device=dev),
        obj_ids=torch.full((n_points,), -1, dtype=torch.int32, device=dev),
        colors=torch.zeros((n_points, 3), dtype=torch.uint8, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        next_point_id=torch.zeros((), dtype=torch.int32, device=dev),
    )


def strided_unproject(depth_ds: torch.Tensor, K: torch.Tensor,
                      c2w: torch.Tensor, downscale: int) -> torch.Tensor:
    """Unproject a subsampled depth map keeping the ORIGINAL full-res pixel
    coordinates (the reference slices the pixel grid, it does not rescale
    the intrinsics) -> (h*w, 3) world points."""
    h, w = depth_ds.shape
    dev = depth_ds.device
    v = (torch.arange(h, dtype=torch.float32, device=dev) * downscale)[:, None]
    u = (torch.arange(w, dtype=torch.float32, device=dev) * downscale)[None, :]
    x = (u - K[0, 2]) * depth_ds / K[0, 0]
    y = (v - K[1, 2]) * depth_ds / K[1, 1]
    cam = torch.stack([x, y, depth_ds], dim=-1).reshape(-1, 3)
    return geo.transform_points(c2w, cam)


@torch.no_grad()
def map_insert_frame(state: MapState, image: torch.Tensor,
                     depth: torch.Tensor, c2w: torch.Tensor,
                     K: torch.Tensor, *, k_pooling: int = 3,
                     downscale: int = 2, match_th: float = 0.03,
                     w2c: Optional[torch.Tensor] = None) -> MapState:
    """One vanilla mapping step: reproject the map, suppress pixels it
    already explains, erode, subsample, unproject the survivors and append
    them. Updates ``state``'s buffers in place (see module docstring).

    image (H, W, 3) u8; depth (H, W) f32 (0 = invalid); c2w (4, 4); K (3, 3)
    at depth resolution; ``w2c`` = inv(c2w) when the caller has it."""
    mask = depth > 0
    corners = geo.compute_camera_frustum_corners(depth, c2w, K)
    in_frustum = geo.points_in_frustum(state.points, corners,
                                       valid=state.valid_mask())
    matched, uv = geo.match_points_to_depth(depth,
                                            geo.inverse_pose(c2w, w2c),
                                            state.points, K,
                                            match_th, valid=in_frustum)
    hh, ww = depth.shape
    hits = geo.hit_mask_scatter(uv[:, 1] * ww + uv[:, 0], matched,
                                hh * ww).reshape(hh, ww)
    # the dedup path and the empty-map path, selected on the device (no
    # host read of count)
    dedup = geo.max_pool_erode(mask & ~hits, k_pooling, stride=downscale)
    mask = torch.where(state.count > 0, dedup,
                       geo.subsample2d(mask, downscale))

    if downscale > 1:
        depth_ds = geo.subsample2d(depth, downscale)
        image_ds = geo.subsample2d(image, downscale)
        points = strided_unproject(depth_ds, K, c2w, downscale)
    else:
        image_ds = image
        points = geo.unproject_depth(depth, K, c2w)
    return _scatter_append(state, points, image_ds.reshape(-1, 3),
                           mask.reshape(-1))


def _scatter_append(state: MapState, points: torch.Tensor,
                    colors: torch.Tensor, new_mask: torch.Tensor,
                    obj_vals: Optional[torch.Tensor] = None) -> MapState:
    """Append points[new_mask] (row-major order) at offset ``count``, in
    place; rows past capacity are dropped. ``obj_vals``: optional (W,) i32
    instance ids of the appended rows (default -1).

    Sync-free: the new rows are stably compacted to the front of a
    W-row window anchored at min(count, N - W), blended with the window's
    old contents and written back with one index_copy_ per buffer; ids of
    the appended rows are their rank."""
    Wn = new_mask.shape[0]
    N = state.capacity
    dev = state.device
    ni = new_mask.to(torch.int32)
    n_new = ni.sum(dtype=torch.int32)
    if obj_vals is None:
        obj_vals = torch.full((Wn,), -1, dtype=torch.int32, device=dev)
    obj_vals = obj_vals.to(torch.int32)
    points = points.float()
    colors = colors.to(torch.uint8)

    if Wn >= N:  # degenerate tiny-map case (tests): scatter with sentinel
        order = ni.cumsum(0, dtype=torch.int32) - 1
        dest = torch.where(new_mask, state.count + order,
                           torch.full_like(order, N))
        dest = torch.where(dest < N, dest, torch.full_like(dest, N)).long()
        ids = state.next_point_id + order

        def put(buf, vals):
            ext = torch.cat([buf, buf.new_zeros((1,) + buf.shape[1:])])
            ext.index_put_((dest,), vals.to(buf.dtype))
            buf.copy_(ext[:N])

        put(state.points, points)
        put(state.colors, colors)
        put(state.point_ids, ids)
        put(state.obj_ids, obj_vals)
    else:
        start = state.count.clamp_max(N - Wn)
        offset = state.count - start            # 0 unless the map is near full
        perm = torch.argsort((~new_mask).to(torch.uint8), stable=True)
        i = torch.arange(Wn, device=dev, dtype=torch.int32)
        is_new = (i >= offset) & (i < offset + n_new)
        # row offset + r of the window takes the r-th new row
        perm_r = perm.index_select(0, (i.long() - offset.long()) % Wn)
        win = start.long() + i.long()

        def window_write(buf, comp):
            old = buf.index_select(0, win)
            sel = is_new if old.dim() == 1 else is_new[:, None]
            buf.index_copy_(0, win, torch.where(sel, comp.to(buf.dtype), old))

        window_write(state.points, points.index_select(0, perm_r))
        window_write(state.colors, colors.index_select(0, perm_r))
        window_write(state.obj_ids, obj_vals.index_select(0, perm_r))
        rank_ids = (state.next_point_id + (i - offset)).to(torch.int32)
        window_write(state.point_ids, rank_ids)

    new_count = (state.count + n_new).clamp_max(N)
    return state._replace(count=new_count.to(torch.int32),
                          next_point_id=(state.next_point_id + n_new).to(
                              torch.int32))


def grow_map_state(state: MapState, new_capacity: int) -> MapState:
    """Re-pad the buffers to a larger capacity bucket."""
    if new_capacity <= state.capacity:
        return state
    pad = new_capacity - state.capacity
    fresh = init_map_state(pad, state.device)
    return MapState(
        points=torch.cat([state.points, fresh.points]),
        point_ids=torch.cat([state.point_ids, fresh.point_ids]),
        obj_ids=torch.cat([state.obj_ids, fresh.obj_ids]),
        colors=torch.cat([state.colors, fresh.colors]),
        count=state.count,
        next_point_id=state.next_point_id,
    )


def map_dict(state: MapState) -> dict:
    """Reference-compatible checkpoint dict: the valid prefix only, int32
    ids, the reference's keys and layouts."""
    n = int(state.count)
    return {
        "xyz": state.points[:n].cpu().numpy(),
        "obj_ids": state.obj_ids[:n].cpu().numpy().reshape(-1, 1),
        "ids": state.point_ids[:n].cpu().numpy().reshape(-1, 1),
        "max_id": int(state.next_point_id),
        "color": state.colors[:n].cpu().numpy(),
    }


def from_map_dict(d: dict, capacity: Optional[int] = None,
                  device="cpu") -> MapState:
    xyz = np.asarray(d["xyz"], dtype=np.float32)
    n = xyz.shape[0]
    cap = capacity or max(1, n)
    if cap < n:
        raise ValueError(f"capacity {cap} < checkpoint points {n}")
    state = init_map_state(cap, device)
    state.points[:n] = torch.from_numpy(xyz)
    state.point_ids[:n] = torch.from_numpy(
        np.asarray(d["ids"]).reshape(-1).astype(np.int32))
    state.obj_ids[:n] = torch.from_numpy(
        np.asarray(d["obj_ids"]).reshape(-1).astype(np.int32))
    state.colors[:n] = torch.from_numpy(
        np.asarray(d["color"]).reshape(n, 3).astype(np.uint8))
    return state._replace(
        count=torch.tensor(n, dtype=torch.int32, device=state.device),
        next_point_id=torch.tensor(int(d["max_id"]), dtype=torch.int32,
                                   device=state.device))
