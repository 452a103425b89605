"""Separable image resize as two matmuls (port of ``ovo_tpu/ops/resize.py``).

Half-pixel centers, edges clamped, no antialias: matches torch's
``F.interpolate(..., align_corners=False, antialias=False)`` (the
reference's convention). The products run in f32 on values rounded to the
input dtype, like the reference's ``preferred_element_type=f32``.

:func:`scale_and_translate` is ``jax.image.scale_and_translate`` with the
bilinear (triangle) kernel and antialiasing, with a scale and translation per
image held in tensors, so per-mask crops need no host sync.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    t = np.abs(t)
    return np.where(
        t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
        np.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a,
                 0.0))


@functools.lru_cache(maxsize=256)
def _interp_matrix(src: int, dst: int, kind: str = "linear") -> np.ndarray:
    """(src, dst) interpolation matrix with half-pixel centers and edge
    clamping; cubic rows renormalized so weights sum to 1."""
    scale = src / dst
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    m = np.zeros((src, dst), np.float32)
    if kind == "linear":
        lo = np.floor(pos).astype(np.int64)
        w_hi = (pos - lo).astype(np.float32)
        np.add.at(m, (np.clip(lo, 0, src - 1), np.arange(dst)), 1.0 - w_hi)
        np.add.at(m, (np.clip(lo + 1, 0, src - 1), np.arange(dst)), w_hi)
    elif kind == "cubic":
        base = np.floor(pos).astype(np.int64)
        for k in range(-1, 3):
            idx = base + k
            w = _cubic_weight(pos - idx).astype(np.float32)
            np.add.at(m, (np.clip(idx, 0, src - 1), np.arange(dst)), w)
        m /= np.maximum(m.sum(axis=0, keepdims=True), 1e-8)
    else:
        raise ValueError(kind)
    return m


# device copies of the matrices: uploading them per call would put a
# pageable host->device copy (a stream sync) on the per-keyframe path
_device_mats: Dict[tuple, torch.Tensor] = {}


def _mat(src: int, dst: int, kind: str, dtype: torch.dtype,
         device: torch.device) -> torch.Tensor:
    key = (src, dst, kind, dtype, str(device))
    m = _device_mats.get(key)
    if m is None:
        from .. import to_device

        m = to_device(_interp_matrix(src, dst, kind), device).to(
            dtype).float()
        _device_mats[key] = m
    return m


def resize_planes(x: torch.Tensor, out_hw: Tuple[int, int], *,
                  kind: str = "linear") -> torch.Tensor:
    """(M, h, w) -> (M, H, W)."""
    mh = _mat(x.shape[1], out_hw[0], kind, x.dtype, x.device)
    mw = _mat(x.shape[2], out_hw[1], kind, x.dtype, x.device)
    y = torch.matmul(x.float().transpose(1, 2), mh).transpose(1, 2)  # mHw
    return torch.matmul(y, mw).to(x.dtype)


def resize_channels_last(x: torch.Tensor, out_hw: Tuple[int, int], *,
                         kind: str = "linear") -> torch.Tensor:
    """(h, w, C) or (B, h, w, C) -> (..., H, W, C). Small channel counts
    (an RGB image's C=3) go through the planes layout."""
    batched = x.dim() == 4
    h, w = (x.shape[1:3] if batched else x.shape[:2])
    C = x.shape[-1]
    if C < 32:
        planes = x.reshape(-1, h, w, C) if batched else x[None]
        planes = planes.permute(0, 3, 1, 2).reshape(-1, h, w)
        out = resize_planes(planes, out_hw, kind=kind)
        out = out.reshape(-1, C, out_hw[0], out_hw[1]).permute(0, 2, 3, 1)
        return out if batched else out[0]
    mh = _mat(h, out_hw[0], kind, x.dtype, x.device)
    mw = _mat(w, out_hw[1], kind, x.dtype, x.device)
    xf = x.float()
    y = torch.einsum("...hwc,hH->...Hwc", xf, mh)
    return torch.einsum("...Hwc,wW->...HWc", y, mw).to(x.dtype)


def bilinear_weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                        translation: torch.Tensor,
                        inv_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(N, in_size, out_size) f32 weights of ``jax.image``'s
    ``compute_weight_mat`` for the triangle kernel with antialiasing, one
    (scale, translation) pair per row of the (N,) tensors: the kernel is
    widened by 1/scale when downscaling, weights are renormalized per output
    sample, and samples outside [-0.5, in_size - 0.5] get no weight (the
    black border of a padded crop). ``inv_scale``: 1/scale as the caller
    rounded it (default: the f32 quotient)."""
    scale = scale.float()
    translation = translation.float()
    inv = (1.0 / scale if inv_scale is None else inv_scale.float())[:, None]
    kscale = torch.clamp(inv, min=1.0)[:, :, None]
    out_idx = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    # (i + 0.5) * inv - t * inv with one rounding after the subtraction (a
    # fused multiply-add, as XLA evaluates it): at a crop offset of a few
    # hundred pixels one f32 step of a sample position is 3e-5 px, and a
    # mask's edge moves the crop by as much
    t_inv = (translation[:, None] * inv).double()
    sample = ((out_idx[None] + 0.5).double() * inv.double()
              - t_inv).float() - 0.5
    in_idx = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    x = (sample[:, None, :] - in_idx[None, :, None]).abs() / kscale
    w = torch.clamp(1.0 - x, min=0.0)
    tot = w.sum(dim=1, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def scale_and_translate(x: torch.Tensor, out_hw: Tuple[int, int],
                        scale: torch.Tensor, translation: torch.Tensor,
                        inv_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``jax.image.scale_and_translate(x, out, (0, 1), scale, translation,
    "bilinear")`` per image: x (N, H, W, C), or (H, W, C) shared by every
    image; scale, translation and the optional ``inv_scale`` (N, 2)
    tensors, (y, x) order -> (N, oh, ow, C) in f32."""
    h, w = x.shape[-3], x.shape[-2]
    inv = (None, None) if inv_scale is None else (inv_scale[:, 0],
                                                  inv_scale[:, 1])
    wy = bilinear_weight_mat(h, out_hw[0], scale[:, 0], translation[:, 0],
                             inv[0])
    wx = bilinear_weight_mat(w, out_hw[1], scale[:, 1], translation[:, 1],
                             inv[1])
    xf = x.float()
    if x.dim() == 3:
        y = torch.einsum("hwc,nwq->nhqc", xf, wx)
    else:
        y = torch.einsum("nhwc,nwq->nhqc", xf, wx)
    return torch.einsum("nhqc,nhp->npqc", y, wy)
