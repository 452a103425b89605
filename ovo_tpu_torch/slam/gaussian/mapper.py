"""Keyframe mapping: seed new gaussians, grow the map, optimize the submap
(port of ``ovo_tpu/slam/gaussian/mapper.py``).

Seeding mask (low alpha or a large depth error on a render, or every valid
pixel for a new submap), seeds picked by hashed pixel scores with edge
pixels first, radius dedup by the Morton-window kNN op, then Adam over a
window of keyframes (L1 color + SSIM + depth + isotropic losses) and
opacity pruning. The Adam loop is the reference's, written out: bias
correction folded into the step, eps added to sqrt(v), invalid slots
frozen.

Host reads per mapped keyframe (all through ``splat.read_host``): the
pair total of the keyframe's view before seeding, the pair totals of the
window's views after seeding (they size the renders' pair buffers), and,
every PAIR_CHECK_EVERY iterations, the largest pair total of the chunk
(a chunk whose renders outgrew the buffer runs again with a larger one).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...ops.knn import approx_knn_mean_dist, radius_dedup_mask
from ...ops.splat import pair_bucket, pair_count, read_host, render_gaussians
from .losses import isotropic_loss, ssim
from .model import GaussianState, add_points, prune_by_opacity


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over all elements: the mean of the two middle values
    of an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def sobel_edge_mask(gray: torch.Tensor, th: float = 0.1) -> torch.Tensor:
    """Edge mask by central-difference gradient magnitude (wrapping)."""
    gx = torch.roll(gray, -1, 1) - torch.roll(gray, 1, 1)
    gy = torch.roll(gray, -1, 0) - torch.roll(gray, 1, 0)
    return torch.sqrt(gx * gx + gy * gy) > th


def seeding_mask(state: GaussianState, image, depth, w2c, K,
                 is_new_submap: bool, *, img_hw: Tuple[int, int],
                 alpha_th: float = 0.6, depth_err_mult: float = 50.0,
                 tile: int = 16, k_per_tile: int = 64,
                 pair_cap: Optional[int] = None) -> torch.Tensor:
    """Pixels that should seed new gaussians: every valid-depth pixel of a
    new submap, else those a render leaves uncovered or far off."""
    if is_new_submap:
        return depth > 0
    with torch.no_grad():
        out = render_gaussians(state.xyz, state.scales(), state.quats,
                               state.opacity(), state.colors(), state.valid,
                               w2c, K, img_hw=img_hw, tile=tile,
                               k_per_tile=k_per_tile, pair_cap=pair_cap)
        d_err = torch.abs(out.depth - depth)
        med = median(torch.where(depth > 0, d_err, 0.0))
        uncovered = (out.alpha < alpha_th) | (
            (depth > 0) & (d_err > depth_err_mult * torch.clamp(med,
                                                                 min=1e-6)))
        return uncovered & (depth > 0)


def select_seeds(mask, depth, image, w2c, K, *, max_seeds: int = 16384,
                 c2w: Optional[torch.Tensor] = None):
    """Unproject up to ``max_seeds`` masked pixels -> (points, colors,
    valid), highest score first (ties to the lower pixel index, as
    ``lax.top_k``): a 16-bit pixel hash, plus 2^16 on edge pixels.
    ``c2w`` is inv(w2c) when the caller has it."""
    H, W = depth.shape
    dev = depth.device
    v, u = torch.meshgrid(torch.arange(H, device=dev),
                          torch.arange(W, device=dev), indexing="ij")
    # the reference's uint32 hash keeps its low 16 bits: int64 gives the
    # same bits
    h = (u * 2654435761 + v * 40503) & 0xFFFF
    edge = sobel_edge_mask(image.mean(-1))
    score = h.to(torch.float32) + torch.where(edge, 65536.0, 0.0)
    score = torch.where(mask, score, float("-inf")).reshape(-1)
    top, idx = torch.sort(score, descending=True, stable=True)
    n = min(max_seeds, score.shape[0])
    top, idx = top[:n], idx[:n]
    valid = torch.isfinite(top)
    uu = (idx % W).to(torch.float32)
    vv = (idx // W).to(torch.float32)
    z = depth.reshape(-1)[idx]
    x = (uu - K[0, 2]) * z / K[0, 0]
    y = (vv - K[1, 2]) * z / K[1, 1]
    if c2w is None:
        c2w = torch.linalg.inv_ex(w2c)[0]
    R, t = c2w[:3, :3], c2w[:3, 3]
    pts = x[:, None] * R[:, 0] + y[:, None] * R[:, 1] + z[:, None] * R[:, 2] \
        + t
    cols = image.reshape(-1, 3)[idx]
    return pts, cols, valid


class MapperConfig(NamedTuple):
    iters: int = 60
    lr_xyz: float = 5e-4
    lr_fdc: float = 5e-3
    lr_scale: float = 2e-3
    lr_quat: float = 1e-3
    lr_opacity: float = 2e-2
    color_w: float = 1.0
    ssim_w: float = 0.2
    depth_w: float = 1.0
    iso_w: float = 10.0
    prune_opacity_th: float = 0.1
    max_seeds: int = 16384
    dedup_radius: float = 0.02
    tile: int = 16
    k_per_tile: int = 64
    # gradient densification (0 = off, as the reference mapper)
    densify_grad_th: float = 0.0
    densify_percent_dense: float = 0.01
    # the reference's knobs: the new submap (frame 0) gets more iterations
    # and a denser seed budget
    new_submap_iters: int = 0        # new_submap_iterations; 0 -> iters
    new_submap_max_seeds: int = 0    # new_submap_points_num; 0 -> max_seeds
    current_frame_frac: float = 0.4  # current_view_opt_iterations
    alpha_th: float = 0.6            # mapping.alpha_thre
    seed_depth_mult: float = 1.005   # seeds at 1.005 * depth
    # statistical-outlier seed filter: kNN mean distance above mean +
    # seed_outlier_std * std drops the seed
    filter_seed_outliers: bool = False
    seed_outlier_std: float = 2.0


OPT_FIELDS = ("xyz", "f_dc", "scales_log", "quats", "opacity_logit")


def _lrs(cfg: MapperConfig) -> dict:
    return {"xyz": cfg.lr_xyz, "f_dc": cfg.lr_fdc,
            "scales_log": cfg.lr_scale, "quats": cfg.lr_quat,
            "opacity_logit": cfg.lr_opacity}


def adam_corr(step: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The folded bias correction sqrt(1 - b2^t) / (1 - b1^t), in f32 as
    the reference computes it."""
    f = np.float32
    return float(np.sqrt(f(1) - f(b2) ** f(step)) / (f(1) - f(b1) ** f(step)))


def mapping_loss(state: GaussianState, params: dict, image, depth, w2c, K,
                 *, img_hw, cfg: MapperConfig, pair_cap=None):
    """The mapping loss of ``params`` on one keyframe, and the render."""
    st = state._replace(**params)
    out = render_gaussians(st.xyz, st.scales(), st.quats, st.opacity(),
                           st.colors(), st.valid, w2c, K, img_hw=img_hw,
                           tile=cfg.tile, k_per_tile=cfg.k_per_tile,
                           pair_cap=pair_cap)
    dv = depth > 0
    n = torch.clamp(dv.sum(), min=1)
    c_l1 = torch.abs(out.color - image).mean()
    s = 1.0 - ssim(out.color, image)
    d_l1 = (torch.abs(out.depth - depth) * dv).sum() / n
    iso = isotropic_loss(params["scales_log"], state.valid)
    loss = (cfg.color_w * c_l1 + cfg.ssim_w * s + cfg.depth_w * d_l1
            + cfg.iso_w * iso)
    return loss, out


def optimize_phase(state: GaussianState, m: dict, v: dict, grad_accum,
                   denom, kf_images, kf_depths, kf_w2cs, kf_schedule, K, *,
                   img_hw: Tuple[int, int], cfg: MapperConfig, it0: int,
                   n_iters: int, pair_cap: Optional[int] = None):
    """``n_iters`` Adam steps from global step ``it0``, moments carried in
    and out; also accumulates each gaussian's world-space positional
    gradient norm (the densification signal). ``kf_schedule`` is a host
    array of window indices, one per global step. Returns (state, m, v,
    grad_accum, denom, max_pairs): the last, () on the device, the largest
    pair total of the phase's renders (see ``ops/splat.py``)."""
    lrs = _lrs(cfg)
    b1, b2, eps = 0.9, 0.999, 1e-8
    valid = state.valid
    params = {k: getattr(state, k).detach().clone().requires_grad_(True)
              for k in OPT_FIELDS}
    m, v = dict(m), dict(v)
    max_pairs = torch.zeros((), dtype=torch.int64, device=state.device)
    for i in range(it0, it0 + n_iters):
        kf = int(kf_schedule[i])
        loss, out = mapping_loss(state, params, kf_images[kf], kf_depths[kf],
                                 kf_w2cs[kf], K, img_hw=img_hw, cfg=cfg,
                                 pair_cap=pair_cap)
        grads = torch.autograd.grad(loss, [params[k] for k in OPT_FIELDS])
        g = dict(zip(OPT_FIELDS, grads))
        with torch.no_grad():
            max_pairs = torch.maximum(max_pairs, out.n_pairs)
            gnorm = torch.sqrt((g["xyz"] ** 2).sum(-1))
            grad_accum = grad_accum + torch.where(valid, gnorm, 0.0)
            denom = denom + (valid & (gnorm > 0)).to(torch.int32)
            corr = adam_corr(i + 1, b1, b2)
            for k in OPT_FIELDS:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
                upd = lrs[k] * corr * m[k] / (torch.sqrt(v[k]) + eps)
                mask = valid.reshape((-1,) + (1,) * (upd.ndim - 1))
                params[k].sub_(torch.where(mask, upd, 0.0))
    new = state._replace(**{k: p.detach() for k, p in params.items()})
    return new, m, v, grad_accum, denom, max_pairs


def _zero_moments(state: GaussianState):
    m = {k: torch.zeros_like(getattr(state, k)) for k in OPT_FIELDS}
    v = {k: torch.zeros_like(getattr(state, k)) for k in OPT_FIELDS}
    ga = torch.zeros(state.capacity, dtype=torch.float32,
                     device=state.device)
    dn = torch.zeros(state.capacity, dtype=torch.int32, device=state.device)
    return m, v, ga, dn


# iterations between the mapper's checks of the pair buffer: a chunk whose
# renders outgrew it runs again (the map grows while it is optimized)
PAIR_CHECK_EVERY = 50


def _checked_phase(state, m, v, ga, dn, window, sched, K, *, img_hw, cfg,
                   it0, n_iters, pair_cap):
    """optimize_phase in chunks of PAIR_CHECK_EVERY iterations, the pair
    buffer checked after each (one host read): a chunk whose renders
    outgrew ``pair_cap`` runs again from its own inputs with a buffer sized
    to what it needed. Returns optimize_phase's outputs but the pair
    total."""
    carry = (state, m, v, ga, dn)
    end = it0 + n_iters
    it = it0
    while it < end:
        n = n_iters if pair_cap is None else min(PAIR_CHECK_EVERY, end - it)
        out = optimize_phase(*carry, *window, sched, K, img_hw=img_hw,
                             cfg=cfg, it0=it, n_iters=n, pair_cap=pair_cap)
        if pair_cap is not None:
            (need,) = read_host(out[-1])
            if need > pair_cap:
                pair_cap = pair_bucket(need)
                continue
        carry = out[:5]
        it += n
    return carry


def optimize_submap(state: GaussianState, kf_images, kf_depths, kf_w2cs,
                    kf_schedule, K, *, img_hw: Tuple[int, int],
                    cfg: MapperConfig, pair_cap: Optional[int] = None
                    ) -> GaussianState:
    """``cfg.iters`` Adam steps against the keyframe window from zero
    moments."""
    m, v, ga, dn = _zero_moments(state)
    return _checked_phase(state, m, v, ga, dn,
                          (kf_images, kf_depths, kf_w2cs), kf_schedule, K,
                          img_hw=img_hw, cfg=cfg, it0=0, n_iters=cfg.iters,
                          pair_cap=pair_cap)[0]


def keyframe_sampling_schedule(iters: int, window: int, seed: int,
                               cur_frac: float = 0.4) -> np.ndarray:
    """Host-side keyframe index schedule: the newest keyframe draws a
    ``cur_frac`` share of the iterations, the rest uniform over the OTHER
    keyframes of the window."""
    rng = np.random.default_rng(seed)
    if window <= 1:
        return np.zeros(iters, np.int32)
    sched = rng.integers(0, window - 1, size=iters)
    cur = rng.random(iters) < cur_frac
    sched[cur] = window - 1
    return sched.astype(np.int32)


def _nan_mean_std(x: torch.Tensor):
    """``jnp.nanmean`` and ``jnp.nanstd`` (ddof 0) over all elements."""
    ok = ~torch.isnan(x)
    n = ok.sum()
    mean = torch.where(ok, x, 0.0).sum() / n
    var = torch.where(ok, (x - mean) ** 2, 0.0).sum() / n
    return mean, torch.sqrt(var)


def _window_cap(state, kf_w2cs, n_views, K, img_hw, tile) -> int:
    counts = torch.stack([pair_count(state.xyz, state.scales(), state.quats,
                                     state.valid, kf_w2cs[i], K,
                                     img_hw=img_hw, tile=tile)
                          for i in range(n_views)])
    return pair_bucket(max(read_host(counts)))


def map_keyframe(state: GaussianState, image, depth, w2c, K, kf_images,
                 kf_depths, kf_w2cs, *, is_new_submap: bool, seed: int,
                 n_live_kfs: Optional[int] = None, img_hw: Tuple[int, int],
                 cfg: MapperConfig, c2w: Optional[torch.Tensor] = None
                 ) -> GaussianState:
    """Seed -> dedup-grow -> optimize -> prune. The keyframe window may be
    padded to a fixed size; ``n_live_kfs`` bounds the sampling schedule
    (the newest live keyframe at index n_live_kfs - 1). ``c2w``: inv(w2c)
    when the caller has it. The renders' pair buffers are sized from host
    reads of the pair totals (the module's docstring)."""
    cap = None
    if not is_new_submap:
        (n0,) = read_host(pair_count(state.xyz, state.scales(), state.quats,
                                     state.valid, w2c, K, img_hw=img_hw,
                                     tile=cfg.tile))
        cap = pair_bucket(n0)
    m = seeding_mask(state, image, depth, w2c, K, is_new_submap,
                     img_hw=img_hw, alpha_th=cfg.alpha_th, tile=cfg.tile,
                     k_per_tile=cfg.k_per_tile, pair_cap=cap)
    max_seeds, n_iters = cfg.max_seeds, cfg.iters
    if is_new_submap:
        max_seeds = min(cfg.new_submap_max_seeds or max_seeds,
                        depth.shape[0] * depth.shape[1])
        n_iters = cfg.new_submap_iters or n_iters
    pts, cols, valid = select_seeds(m, depth * cfg.seed_depth_mult, image,
                                    w2c, K, max_seeds=max_seeds, c2w=c2w)
    if cfg.filter_seed_outliers and not is_new_submap:
        d = approx_knn_mean_dist(pts, valid, k=3)
        mean, std = _nan_mean_std(torch.where(valid, d, float("nan")))
        valid = valid & (d <= mean + cfg.seed_outlier_std * std)
    keep = radius_dedup_mask(pts, valid, state.xyz, state.valid,
                             cfg.dedup_radius)
    state = add_points(state, pts, cols, keep)
    window = n_live_kfs if n_live_kfs is not None else kf_images.shape[0]
    sched = keyframe_sampling_schedule(n_iters, window, seed,
                                       cur_frac=cfg.current_frame_frac)
    views = (kf_images, kf_depths, kf_w2cs)
    cap = _window_cap(state, kf_w2cs, window, K, img_hw, cfg.tile)
    if cfg.densify_grad_th <= 0:
        state = optimize_submap(state, *views, sched, K, img_hw=img_hw,
                                cfg=cfg._replace(iters=n_iters),
                                pair_cap=cap)
        return prune_by_opacity(state, cfg.prune_opacity_th)

    # densify: optimize half, clone / split on the accumulated gradient
    # norms, zero the appended slots' moments, optimize the other half
    from .model import densify_clone_split

    m, v, ga, dn = _zero_moments(state)
    half = max(n_iters // 2, 1)
    state, m, v, ga, dn = _checked_phase(
        state, m, v, ga, dn, views, sched, K, img_hw=img_hw, cfg=cfg, it0=0,
        n_iters=half, pair_cap=cap)
    grad_avg = ga / torch.clamp(dn.to(torch.float32), min=1.0)
    state, appended = densify_clone_split(
        state, grad_avg, cfg.densify_grad_th, cfg.densify_percent_dense,
        generator=torch.Generator(state.device).manual_seed(seed))
    for mom in (m, v):
        for k in OPT_FIELDS:
            mom[k] = torch.where(appended.reshape(
                (-1,) + (1,) * (mom[k].ndim - 1)), 0.0, mom[k])
    cap = _window_cap(state, kf_w2cs, window, K, img_hw, cfg.tile)
    state = _checked_phase(state, m, v, ga, dn, views, sched, K,
                           img_hw=img_hw, cfg=cfg, it0=half,
                           n_iters=n_iters - half, pair_cap=cap)[0]
    return prune_by_opacity(state, cfg.prune_opacity_th)
