"""Approximate nearest-neighbour ops on the device (port of
``ovo_tpu/ops/knn.py``: the Gaussian-SLAM tier's stand-ins for
simple-knn's ``distCUDA2`` and faiss radius dedup).

Points are ordered by the Morton code of their quantized coordinates, then
each is compared with a +/- ``window`` of its sorted neighbours. The codes
are carried as int64 (torch has no uint32 arithmetic): every product of
the bit spreading stays below 2^41 and is masked to 32 bits, so the codes
equal the reference's uint32 ones; 0xFFFFFFFF marks invalid points. The
orders are stable sorts, as ``jnp.argsort``'s: codes tie often, and the tie
order decides which points share a window.
"""
from __future__ import annotations

import torch

_MORTON_BITS = 10  # 1024^3 grid
_INVALID = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N,) int64 Morton codes (< 2^30) over [lo, hi]."""
    top = 2 ** _MORTON_BITS - 1
    scale = (hi - lo) / top
    q = torch.clamp((points - lo) / torch.clamp(scale, min=1e-12), 0,
                    top).to(torch.int64)
    return (_expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1)
            | (_expand_bits(q[:, 2]) << 2))


def _sorted_by_code(points: torch.Tensor, valid: torch.Tensor):
    big = 1e9
    lo = torch.where(valid[:, None], points, big).amin(dim=0)
    hi = torch.where(valid[:, None], points, -big).amax(dim=0)
    codes = torch.where(valid, morton_codes(points, lo, hi), _INVALID)
    return torch.argsort(codes, stable=True)


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((a - b) ** 2).sum(dim=-1))


def approx_knn_mean_dist(points: torch.Tensor, valid: torch.Tensor,
                         k: int = 3, window: int = 32) -> torch.Tensor:
    """Per-point mean distance to ~k nearest neighbours (0 for invalid
    points; a neighbour slot with no valid point counts 0)."""
    order = _sorted_by_code(points, valid)
    sp, sv = points[order], valid[order]
    dists = []
    for s in range(-window, window + 1):
        if s == 0:
            continue
        d = _dist(sp, torch.roll(sp, s, dims=0))
        dists.append(torch.where(sv & torch.roll(sv, s, dims=0), d,
                                 float("inf")))
    nearest = torch.topk(torch.stack(dists, dim=1), k, dim=1,
                         largest=False).values
    mean = torch.where(torch.isfinite(nearest), nearest, 0.0).mean(dim=1)
    out = torch.zeros_like(mean).scatter_(0, order, mean)
    return torch.where(valid, out, 0.0)


def radius_dedup_mask(new_points: torch.Tensor, new_valid: torch.Tensor,
                      ref_points: torch.Tensor, ref_valid: torch.Tensor,
                      radius: float, window: int = 32) -> torch.Tensor:
    """True where a valid new point has NO valid reference point within
    ``radius`` among its +/- ``window`` Morton neighbours."""
    n_new = new_points.shape[0]
    pts = torch.cat([new_points, ref_points])
    valid = torch.cat([new_valid, ref_valid])
    is_new = torch.arange(pts.shape[0], device=pts.device) < n_new
    order = _sorted_by_code(pts, valid)
    sp, sv, sn = pts[order], valid[order], is_new[order]
    close = torch.zeros_like(sv)
    for s in range(-window, window + 1):
        if s == 0:
            continue
        d = _dist(sp, torch.roll(sp, s, dims=0))
        close |= (sv & torch.roll(sv, s, dims=0) & ~torch.roll(sn, s, dims=0)
                  & (d < radius))
    keep = torch.zeros_like(sv).scatter_(0, order, sn & sv & ~close)
    return keep[:n_new]
