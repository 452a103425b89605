"""Projective-association geometry on fixed-shape tensors (port of
``ovo_tpu/geometry/__init__.py``).

Every function works on full padded point buffers and returns validity
masks instead of compacting, so nothing synchronizes with the host.

Conventions (the reference's):
  - poses are 4x4 camera-to-world (c2w); w2c = inv(c2w)
  - pinhole intrinsics K (3x3); pixel = round(K @ p_cam), u = col, v = row
  - a 3D point matches a pixel iff |z_cam - depth[v, u]| < th and depth > 0
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to (N, 3) points, as broadcast
    elementwise ops in the reference's order (full f32, no matmul)."""
    R, t = T[:3, :3], T[:3, 3]
    return (points[:, 0:1] * R[:, 0] + points[:, 1:2] * R[:, 1]
            + points[:, 2:3] * R[:, 2] + t)


def inverse_pose(c2w: torch.Tensor,
                 w2c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``w2c`` if given, else inv(c2w) by LU on c2w's device."""
    return w2c if w2c is not None else torch.linalg.inv_ex(c2w)[0]


def compute_camera_frustum_corners(depth: torch.Tensor, c2w: torch.Tensor,
                                   K: torch.Tensor) -> torch.Tensor:
    """8 world-space frustum corners from the valid depth extremes."""
    h, w = depth.shape
    valid = depth > 0
    inf = torch.full_like(depth, float("inf"))
    min_d = torch.where(valid, depth, inf).min()
    max_d = torch.where(valid, depth, -inf).max()
    # corner i has (x, y, z) bits (i & 1, i >> 1 & 1, i >> 2 & 1), made on
    # the device (a host-built table would be a synchronizing copy)
    i = torch.arange(8, device=depth.device)
    u = (i & 1).to(depth.dtype) * w
    v = ((i >> 1) & 1).to(depth.dtype) * h
    z = torch.where(((i >> 2) & 1) > 0, max_d, min_d)
    x = (u - K[0, 2]) * z / K[0, 0]
    y = (v - K[1, 2]) * z / K[1, 1]
    return transform_points(c2w, torch.stack([x, y, z], dim=1))


def compute_camera_frustum_planes(corners: torch.Tensor) -> torch.Tensor:
    """Six (a, b, c, d) planes; inside satisfies ax+by+cz+d <= 0. Keeps the
    reference's anchoring quirk (plane i anchored at corners[i])."""
    c = corners

    def cross(a, b):
        return torch.linalg.cross(a, b)

    normals = torch.stack([
        cross(c[2] - c[0], c[1] - c[0]),
        cross(c[6] - c[4], c[5] - c[4]),
        cross(c[4] - c[0], c[2] - c[0]),
        cross(c[7] - c[3], c[1] - c[3]),
        cross(c[5] - c[1], c[3] - c[1]),
        cross(c[6] - c[2], c[0] - c[2]),
    ])
    d = -(normals * c[:6]).sum(dim=1)
    return torch.cat([normals, d[:, None]], dim=1)


def points_in_frustum(points: torch.Tensor, corners: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AABB test AND the 6-plane test over the full padded buffer."""
    lo = corners.amin(dim=0)
    hi = corners.amax(dim=0)
    in_aabb = ((points >= lo) & (points <= hi)).all(dim=1)
    planes = compute_camera_frustum_planes(corners)
    signed = (points[:, 0:1] * planes[:, 0] + points[:, 1:2] * planes[:, 1]
              + points[:, 2:3] * planes[:, 2] + planes[:, 3])
    mask = in_aabb & (signed <= 0).all(dim=1)
    if valid is not None:
        mask = mask & valid
    return mask


def project_points(points: torch.Tensor, K: torch.Tensor,
                   w2c: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 3) points -> ((N, 2) int32 rounded [u, v], (N,) camera z).
    Rounds half to even, as the reference."""
    if w2c is not None:
        points = transform_points(w2c, points)
    z = points[:, 2]
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    u = K[0, 0] * points[:, 0] / safe_z + K[0, 2]
    v = K[1, 1] * points[:, 1] / safe_z + K[1, 2]
    uv = torch.stack([torch.round(u), torch.round(v)], dim=1).to(torch.int32)
    return uv, z


def match_points_to_depth(depth: torch.Tensor, w2c: torch.Tensor,
                          points: torch.Tensor, K: torch.Tensor,
                          th_dist: float,
                          valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(match_mask (N,), uv (N, 2) int32 clamped in-bounds)."""
    h, w = depth.shape
    uv, z = project_points(points, K, w2c)
    in_plane = ((uv[:, 0] >= 0) & (uv[:, 0] < w)
                & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    uc = uv[:, 0].clamp(0, w - 1)
    vc = uv[:, 1].clamp(0, h - 1)
    d = packed_pixel_table(depth)[(vc * w + uc).long(), 0]
    matched = in_plane & ((z - d).abs() < th_dist) & (d != 0)
    if valid is not None:
        matched = matched & valid
    return matched, torch.stack([uc, vc], dim=1)


def depth_filter(depth: torch.Tensor, k_size: int = 7, sigma: float = 2.5,
                 th: float = 0.05) -> torch.Tensor:
    """Pixels deviating from a gaussian-blurred copy by more than ``th`` are
    set to -1, so the depth-match test never passes there."""
    low = gaussian_blur_2d(depth, k_size, sigma)
    high = (depth - low).abs()
    return torch.where(high > th, torch.full_like(depth, -1.0), depth)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    idx = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def gaussian_blur_2d(img: torch.Tensor, k_size: int, sigma: float
                     ) -> torch.Tensor:
    """Separable gaussian blur with reflect padding, as an explicit f32
    shift-and-add (a convolution library call could round differently)."""
    half = (k_size - 1) / 2
    x = torch.linspace(-half, half, k_size, dtype=torch.float32,
                       device=img.device)
    kernel = torch.exp(-0.5 * (x / sigma) ** 2)
    kernel = (kernel / kernel.sum()).to(img.dtype)
    pad = k_size // 2

    def conv_axis(arr: torch.Tensor, axis: int) -> torch.Tensor:
        n = arr.shape[axis]
        padded = arr.index_select(axis, _reflect_index(n, pad, arr.device))
        out = torch.zeros_like(arr)
        for i in range(k_size):
            out = out + kernel[i] * padded.narrow(axis, i, n)
        return out

    return conv_axis(conv_axis(img, 0), 1)


def unproject_depth(depth: torch.Tensor, K: torch.Tensor, c2w: torch.Tensor
                    ) -> torch.Tensor:
    """Every pixel of a depth map to world space -> (H*W, 3)."""
    h, w = depth.shape
    v, u = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device),
        torch.arange(w, dtype=depth.dtype, device=depth.device),
        indexing="ij")
    x = (u - K[0, 2]) * depth / K[0, 0]
    y = (v - K[1, 2]) * depth / K[1, 1]
    cam = torch.stack([x, y, depth], dim=-1).reshape(-1, 3)
    return transform_points(c2w, cam)


def subsample2d(x: torch.Tensor, s: int) -> torch.Tensor:
    """``x[::s, ::s]`` over the two leading dims."""
    if s <= 1:
        return x
    return x[::s, ::s].contiguous()


def max_pool_erode(mask: torch.Tensor, k_size: int, stride: int = 1
                   ) -> torch.Tensor:
    """~maxpool(~mask) with -inf padding; ``stride`` fuses the subsequent
    ``[::stride, ::stride]`` subsample (same window centers)."""
    if k_size <= 1:
        return mask if stride <= 1 else mask[::stride, ::stride]
    pad = k_size // 2
    inv = (~mask).float()[None, None]
    pooled = F.max_pool2d(inv, k_size, stride=stride, padding=pad)
    return ~(pooled[0, 0] > 0)


def packed_pixel_table(*channels: torch.Tensor) -> torch.Tensor:
    """Stack per-pixel (H, W) channels into a flat (H*W, 4) f32 table."""
    if not 1 <= len(channels) <= 4:
        raise ValueError("1 to 4 channels")
    h, w = channels[0].shape
    chans = [c.float() for c in channels]
    chans += [chans[0].new_zeros((h, w))] * (4 - len(chans))
    return torch.stack(chans, dim=-1).reshape(h * w, 4)


def hit_mask_scatter(flat_idx: torch.Tensor, matched: torch.Tensor,
                     hw: int) -> torch.Tensor:
    """Pixels hit by >= 1 matched point, as a flat (hw,) bool mask
    (unmatched rows go to a sentinel cell that is sliced off)."""
    idx = torch.where(matched, flat_idx.long(),
                      torch.full_like(flat_idx, hw, dtype=torch.long))
    hit = torch.zeros(hw + 1, dtype=torch.int32, device=flat_idx.device)
    hit.index_fill_(0, idx, 1)
    return hit[:hw] != 0
