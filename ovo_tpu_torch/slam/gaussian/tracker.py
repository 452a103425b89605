"""Camera tracking by differentiable-rendering pose optimization (port of
``ovo_tpu/slam/gaussian/tracker.py``).

From an initial pose, Adam on a quaternion and a translation against the
frame's color / depth L1 under the reference's masks (valid depth,
optional alpha coverage, a 50 x median depth-outlier gate; color soft-
weighted by alpha^3), keeping the best-loss pose on the device. The
reference's adaptive budget (twice the iterations when the initial loss
exceeds a threshold) is one host read before the loop; the loop itself
reads nothing. After the loop one read brings the best pose, the losses
and the largest pair total home (a loop whose renders outgrew the pair
buffer runs again with a larger one; see ``ops/splat.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...ops.splat import pair_bucket, read_host, render_gaussians
from .mapper import adam_corr, median
from .model import GaussianState


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """wxyz Hamilton product."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
    w, x, y, z = q
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> wxyz quaternion (branch-free Shepperd)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    qs = torch.stack([
        torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01]),
        torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20]),
        torch.stack([m02 - m20, m01 + m10, 1 + m11 - m00 - m22, m12 + m21]),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 + m22 - m00 - m11]),
    ])
    best = torch.argmax(torch.stack([tr, m00, m11, m22]))
    q = qs.index_select(0, best.reshape(1))[0]
    return q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)


def const_speed_extrapolate(c2w_prev2: np.ndarray,
                            c2w_prev1: np.ndarray) -> np.ndarray:
    """Constant-velocity pose prediction (host, f32)."""
    prev2 = np.asarray(c2w_prev2, np.float32)
    prev1 = np.asarray(c2w_prev1, np.float32)
    return (prev1 @ np.linalg.inv(prev2)) @ prev1


def pose_matrix(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[R(q) t; 0 0 0 1]."""
    top = torch.cat([quat_to_mat(q), t[:, None]], 1)
    # made on the device: setting one element from a Python float would
    # copy it from the host (a synchronization)
    bottom = torch.cat([torch.zeros(1, 3, dtype=t.dtype, device=t.device),
                        torch.ones(1, 1, dtype=t.dtype, device=t.device)], 1)
    return torch.cat([top, bottom], 0)


class TrackResult(NamedTuple):
    w2c: np.ndarray    # (4, 4) f32 optimized world-to-camera
    loss: float        # best loss
    init_loss: float   # loss at the initial pose
    pair_cap: int      # the pair buffer the loop's renders used


def track_pose(state: GaussianState, image, depth, w2c_init, K, *,
               img_hw: Tuple[int, int], iters: int = 60, lr_q: float = 2e-4,
               lr_t: float = 2e-3, color_w: float = 0.5,
               depth_w: float = 1.0, alpha_th: float = 0.98,
               soft_alpha: bool = True, filter_alpha: bool = False,
               filter_outlier_depth: bool = True,
               mask_invalid_depth: bool = False,
               adaptive_loss_th: float = 0.0, tile: int = 16,
               k_per_tile: int = 64,
               pair_cap: Optional[int] = None) -> TrackResult:
    """Optimize the camera pose against one RGB-D frame.

    image: (H, W, 3) f32 in [0, 1]; depth: (H, W) f32 (0 = invalid);
    w2c_init (4, 4) on the state's device. ``adaptive_loss_th`` > 0 doubles
    the iteration budget when the initial loss exceeds it. ``pair_cap``:
    the renders' pair buffer to start from (None: the first render reads
    its total)."""
    scales = state.scales()
    opac = state.opacity()
    cols = state.colors()
    depth_valid = depth > 0

    def render_loss(q, t, cap):
        out = render_gaussians(state.xyz, scales, state.quats, opac, cols,
                               state.valid, pose_matrix(q, t), K,
                               img_hw=img_hw, tile=tile,
                               k_per_tile=k_per_tile, pair_cap=cap)
        alpha = out.alpha
        with torch.no_grad():
            tm = depth_valid
            if filter_alpha:
                tm = tm & (alpha > alpha_th)
            if filter_outlier_depth:
                d_err = torch.abs(out.depth - depth) * depth_valid
                med = median(d_err)
                tm = tm & torch.where(med > 0, d_err < 50.0 * med, True)
        c_l1 = torch.abs(out.color - image).sum(-1)
        d_l1 = torch.abs(out.depth - depth) * tm
        if soft_alpha:
            a3 = alpha ** 3
            if mask_invalid_depth:
                c_l1 = c_l1 * tm
            c_l1 = c_l1 * a3
            d_l1 = d_l1 * a3
        else:
            c_l1 = c_l1 * tm
        return color_w * c_l1.sum() + depth_w * d_l1.sum(), out.n_pairs

    with torch.no_grad():
        q0 = mat_to_quat(w2c_init[:3, :3])
        t0 = w2c_init[:3, 3].clone()
    while True:
        with torch.no_grad():
            init_loss, n_pairs = render_loss(q0, t0, pair_cap)
        init_h, need = read_host(init_loss, n_pairs)
        if pair_cap is None or need <= pair_cap:
            break
        pair_cap = pair_bucket(need)     # the render dropped pairs: again
    pair_cap = pair_bucket(need)
    budget = iters
    if adaptive_loss_th > 0 and init_h > adaptive_loss_th:
        budget = 2 * iters

    b1, b2, eps = 0.9, 0.999, 1e-8
    while True:
        q = q0.clone().requires_grad_(True)
        t = t0.clone().requires_grad_(True)
        mq, vq = torch.zeros_like(q0), torch.zeros_like(q0)
        mt, vt = torch.zeros_like(t0), torch.zeros_like(t0)
        best_q, best_t, best_loss = q0.clone(), t0.clone(), init_loss
        max_pairs = n_pairs
        for i in range(budget):
            loss, n = render_loss(q, t, pair_cap)
            gq, gt = torch.autograd.grad(loss, [q, t])
            with torch.no_grad():
                max_pairs = torch.maximum(max_pairs, n)
                better = loss < best_loss
                best_q = torch.where(better, q, best_q)
                best_t = torch.where(better, t, best_t)
                best_loss = torch.where(better, loss, best_loss)
                mq = b1 * mq + (1 - b1) * gq
                vq = b2 * vq + (1 - b2) * gq * gq
                mt = b1 * mt + (1 - b1) * gt
                vt = b2 * vt + (1 - b2) * gt * gt
                corr = adam_corr(i + 1, b1, b2)
                q -= lr_q * corr * mq / (torch.sqrt(vq) + eps)
                t -= lr_t * corr * mt / (torch.sqrt(vt) + eps)
                q /= torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
        with torch.no_grad():
            w2c = pose_matrix(best_q, best_t)
        vals = read_host(w2c, best_loss, max_pairs)
        if vals[-1] <= pair_cap:
            break
        pair_cap = pair_bucket(vals[-1])
    return TrackResult(w2c=np.asarray(vals[:16], np.float32).reshape(4, 4),
                       loss=vals[16], init_loss=init_h, pair_cap=pair_cap)
