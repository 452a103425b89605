"""Differentiable 3D-gaussian splatting for the Gaussian-SLAM tier (port of
``ovo_tpu/ops/splat.py``).

Tile renderer: project the gaussians (EWA), give each tile its K + 1
nearest touching gaussians (nearest first, ties to the lower index), and
composite the first K front to back; the K + 1-th feeds only the
truncation monitor (``trunc_residual``: the post-K transmittance times the
weight ``n_trunc`` gaussians like the nearest truncated one would take,
maxed over pixels and tiles). Gradients come from autograd, as the
reference's come from JAX's.

The selection. The reference scores every gaussian for every tile (a
(tiles, G) matrix; 3,225 x 2^20 at 680 x 1200 and the Replica capacity) and
takes a top-k per tile. Here the gaussians are ranked by depth once (a
stable sort, so equal depths keep index order), every (gaussian, tile)
pair of a visible gaussian's tile box is generated in that rank order into
a buffer of ``pair_cap`` slots, and a stable sort of the pairs by tile
leaves each tile's touching gaussians nearest first: the first K + 1 of a
tile are the reference's top-k, and its pair count is its touching count.
The pair total depends on the data; the buffer has a fixed size so that a
render never reads the device. ``RenderOutput.n_pairs`` is the total the
render needed: a caller that passed ``pair_cap`` checks ``n_pairs <=
pair_cap`` at its next host read (:func:`read_host`) and renders again with
a larger buffer if not (pairs past the buffer are dropped). With
``pair_cap=None`` the render reads the total first.

The transmittance's cumulative product has its own backward
(:class:`_Cumprod`): torch's checks its input for zeros on the host, and
1 - alpha is at least 0.001 here (alpha is clipped to 0.999).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class RenderOutput(NamedTuple):
    color: torch.Tensor           # (H, W, 3)
    depth: torch.Tensor           # (H, W)
    alpha: torch.Tensor           # (H, W)
    radii: torch.Tensor           # (G,) screen-space radius (0 = culled)
    trunc_residual: torch.Tensor  # () f32, 0 when no tile was truncated
    n_pairs: torch.Tensor         # () i64 (gaussian, tile) pairs needed


def read_host(*tensors: torch.Tensor) -> list:
    """The Gaussian-SLAM tier's host reads of the device: the given
    tensors' values flattened into one f64 list, with one copy (one
    synchronization)."""
    return torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors]).tolist()


def pair_bucket(n_pairs: float) -> int:
    """A pair buffer with half again ``n_pairs`` of room, so that a loop's
    renders rarely outgrow it (every pair slot costs sorting and gathering
    time in every render)."""
    return int(1.5 * n_pairs) + 4096


class _Cumprod(torch.autograd.Function):
    """torch.cumprod with the backward of its zero-free case and no host
    check for zeros: every input here is at least 0.001."""

    @staticmethod
    def forward(ctx, x, dim):
        out = torch.cumprod(x, dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        w = (out * grad).flip(ctx.dim).cumsum(ctx.dim).flip(ctx.dim)
        return w / x, None


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(G, 4) wxyz quaternions -> (G, 3, 3) rotations."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small matrix product as a broadcast sum (no cuBLAS batch of
    millions of 3 x 3 products)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def project_gaussians(xyz, scales, quats, w2c, K, img_hw: Tuple[int, int]):
    """EWA projection: 3D covariance -> 2D screen-space covariance."""
    H, W = img_hw
    R = quat_to_rotmat(quats)
    M = R * scales[:, None, :]                     # R @ diag(s)
    cov3d = _mm(M, M.transpose(-1, -2))
    Rcw, t = w2c[:3, :3], w2c[:3, 3]
    cam = (xyz[:, 0:1] * Rcw[:, 0] + xyz[:, 1:2] * Rcw[:, 1]
           + xyz[:, 2:3] * Rcw[:, 2] + t)
    z = cam[:, 2]
    in_front = z > 0.05
    zs = torch.where(in_front, z, 1.0)
    fx, fy = K[0, 0], K[1, 1]
    u = fx * cam[:, 0] / zs + K[0, 2]
    v = fy * cam[:, 1] / zs + K[1, 2]
    zero = torch.zeros_like(zs)
    J = torch.stack([
        torch.stack([fx / zs, zero, -fx * cam[:, 0] / (zs * zs)], -1),
        torch.stack([zero, fy / zs, -fy * cam[:, 1] / (zs * zs)], -1)], -2)
    T = _mm(J, Rcw.expand(J.shape[0], 3, 3))       # (G, 2, 3)
    cov2d = _mm(_mm(T, cov3d), T.transpose(-1, -2))
    a = cov2d[:, 0, 0] + 0.3                       # + 0.3 px low-pass
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + 0.3
    det = torch.clamp(a * c - b ** 2, min=1e-9)
    conic = torch.stack([torch.stack([c, -b], -1),
                         torch.stack([-b, a], -1)], -2) / det[:, None, None]
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    visible = in_front & (u + radius > 0) & (u - radius < W) & \
        (v + radius > 0) & (v - radius < H)
    return {"uv": torch.stack([u, v], -1), "z": z, "conic": conic,
            "radius": torch.where(visible, radius, 0.0), "visible": visible}


def _tile_boxes(uv, radius, visible, tile, n_tx, n_ty):
    """Each gaussian's tile box (floor division of the float bounds, then
    clipped) and its tile count (0 when not visible), in int32."""
    def cell(x, n):
        return torch.clamp(torch.div(x, tile, rounding_mode="floor"),
                           0, n - 1).to(torch.int32)

    tx0 = cell(uv[:, 0] - radius, n_tx)
    tx1 = cell(uv[:, 0] + radius, n_tx)
    ty0 = cell(uv[:, 1] - radius, n_ty)
    ty1 = cell(uv[:, 1] + radius, n_ty)
    nb = torch.where(visible, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    return tx0, tx1, ty0, nb


def pair_count(xyz, scales, quats, valid, w2c, K, *,
               img_hw: Tuple[int, int], tile: int = 16) -> torch.Tensor:
    """The (gaussian, tile) pairs a render of this view needs: () i64 on
    the device (no read)."""
    with torch.no_grad():
        H, W = img_hw
        proj = project_gaussians(xyz, scales, quats, w2c, K, img_hw)
        _, _, _, nb = _tile_boxes(proj["uv"], proj["radius"],
                                  proj["visible"] & valid, tile,
                                  -(-W // tile), -(-H // tile))
        return nb.sum()


def _select(proj, visible, tile, n_tx, n_ty, k_sel, pair_cap):
    """Per tile the first ``k_sel`` touching gaussians nearest first (idx,
    ok) and the touching count; the pair total. Pair arithmetic in int32
    (a buffer holds fewer than 2^31 pairs); the tiles' ranges in the
    sorted pairs by binary search (no atomics)."""
    n_tiles = n_tx * n_ty
    dev = visible.device
    G = visible.shape[0]
    i32 = torch.int32
    tx0, tx1, ty0, nb = _tile_boxes(proj["uv"], proj["radius"], visible,
                                    tile, n_tx, n_ty)
    # gaussians nearest first, equal depths in index order
    order = torch.argsort(torch.where(visible, proj["z"], float("inf")),
                          stable=True)
    nb_sorted = nb[order]
    cums = torch.cumsum(nb_sorted, 0)
    total = cums[-1]
    if pair_cap is None:
        pair_cap = int(read_host(total)[0])
    pair_cap = max(int(pair_cap), 1)
    cums32 = torch.clamp(cums, max=2 ** 31 - 1).to(i32)
    p = torch.arange(pair_cap, dtype=i32, device=dev)
    s = torch.clamp(torch.searchsorted(cums32, p, right=True,
                                       out_int32=True), max=G - 1)
    g = order.to(i32)[s]
    off = p - (cums32 - nb_sorted)[s]
    w = (tx1 - tx0 + 1)[g]
    tile_of = (ty0[g] + torch.div(off, w, rounding_mode="floor")) * n_tx \
        + tx0[g] + off % w
    key_t = torch.int16 if n_tiles < 2 ** 15 - 1 else i32
    tile_of = torch.where(p < total, tile_of, n_tiles).to(key_t)
    keys, by_tile = torch.sort(tile_of, stable=True)
    edges = torch.searchsorted(
        keys, torch.arange(n_tiles + 1, dtype=key_t, device=dev),
        out_int32=True)
    starts, counts = edges[:-1], edges[1:] - edges[:-1]
    j = torch.arange(k_sel, dtype=i32, device=dev)
    ok = j[None] < counts[:, None]
    pos = torch.clamp(starts[:, None] + j[None], max=pair_cap - 1)
    idx = torch.where(ok, g[by_tile[pos]], 0)
    return idx, ok, counts, total


def render_gaussians(xyz, scales, quats, opacity, colors, valid, w2c, K, *,
                     img_hw: Tuple[int, int], tile: int = 16,
                     k_per_tile: int = 64,
                     pair_cap: Optional[int] = None) -> RenderOutput:
    """Render (color, depth, alpha). Inputs padded to capacity G with a
    ``valid`` mask; opacity already sigmoid-ed, scales exp-ed, colors in
    [0, 1]. ``pair_cap``: the pair buffer's size (see the module's
    docstring); None reads the total needed first."""
    H, W = img_hw
    G = xyz.shape[0]
    dev = xyz.device
    proj = project_gaussians(xyz, scales, quats, w2c, K, img_hw)
    visible = proj["visible"] & valid
    uv, z, conic, radius = proj["uv"], proj["z"], proj["conic"], \
        proj["radius"]
    n_ty, n_tx = -(-H // tile), -(-W // tile)
    k_per_tile = min(k_per_tile, G)
    k_sel = min(k_per_tile + 1, G)
    with torch.no_grad():
        idx_all, ok_all, counts, total = _select(
            {"uv": uv.detach(), "radius": radius.detach(), "z": z.detach()},
            visible, tile, n_tx, n_ty, k_sel, pair_cap)
    n_tiles = n_tx * n_ty
    flat = idx_all.reshape(-1)

    def pick(x):
        return x.index_select(0, flat).reshape(n_tiles, k_sel, *x.shape[1:])

    ti = torch.arange(n_tiles, device=dev)
    pix = torch.arange(tile, device=dev, dtype=torch.float32)
    ys = ((ti // n_tx) * tile).to(torch.float32)[:, None] + pix
    xs = ((ti % n_tx) * tile).to(torch.float32)[:, None] + pix
    sel_uv, sel_conic = pick(uv), pick(conic)
    # dx varies along a tile's columns only and dy along its rows: the
    # (n, k, t, t) products start at the cross term (the same float ops per
    # pixel as on the full grid)
    dx = xs[:, None, None, :] - sel_uv[:, :, 0, None, None]   # (n, k, 1, t)
    dy = ys[:, None, :, None] - sel_uv[:, :, 1, None, None]   # (n, k, t, 1)
    c00 = sel_conic[:, :, 0, 0, None, None]
    c11 = sel_conic[:, :, 1, 1, None, None]
    c01 = sel_conic[:, :, 0, 1, None, None]
    power = -0.5 * (c00 * dx * dx + c11 * dy * dy + 2 * c01 * dx * dy)
    alpha_all = torch.clamp(pick(opacity)[:, :, None, None]
                            * torch.exp(power), 0.0, 0.999)
    K_ = k_per_tile
    ok = ok_all[:, :K_]
    alpha = torch.where(ok[:, :, None, None], alpha_all[:, :K_], 0.0)
    one_m = 1.0 - alpha
    prod = _Cumprod.apply(one_m, 1)
    trans = torch.cat([torch.ones_like(one_m[:, :1]), prod[:, :-1]], 1)
    w = alpha * trans                                  # (n, k, t, t)
    sel_col = colors.index_select(0, flat).reshape(
        n_tiles, k_sel, 3)[:, :K_]
    sel_z = z.index_select(0, flat).reshape(n_tiles, k_sel)[:, :K_]
    color = torch.einsum("nkij,nkc->nijc", w, sel_col)
    depth = torch.einsum("nkij,nk->nij", w, sel_z)
    acc = w.sum(1)
    if k_sel > K_:
        with torch.no_grad():
            n_trunc = torch.clamp(counts - K_, min=0).to(torch.float32)
            a_next = torch.where(ok_all[:, K_, None, None],
                                 alpha_all[:, K_], 0.0)
            final_t = trans[:, -1] * one_m[:, -1]
            missed = 1.0 - (1.0 - a_next) ** n_trunc[:, None, None]
            resid = (final_t * missed).amax()
    else:
        resid = torch.zeros((), device=dev)              # K = G: exact

    def untile(x):
        c = x.shape[3:]
        img = x.reshape(n_ty, n_tx, tile, tile, *c).transpose(1, 2)
        return img.reshape(n_ty * tile, n_tx * tile, *c)[:H, :W]

    return RenderOutput(color=untile(color), depth=untile(depth),
                        alpha=untile(acc),
                        radii=torch.where(visible, radius, 0.0),
                        trunc_residual=resid, n_pairs=total)


def render_gaussians_adaptive(xyz, scales, quats, opacity, colors, valid,
                              w2c, K, *, img_hw: Tuple[int, int],
                              tile: int = 16, k_per_tile: int = 128,
                              residual_th: float = 0.05, max_k: int = 0,
                              pair_cap: Optional[int] = None
                              ) -> Tuple[RenderOutput, int, int]:
    """Render with K escalation: while a truncated tile keeps more than
    ``residual_th`` of its weight past K, double k_per_tile, up to
    ``max_k`` (0 = G: exact compositing). One host read per attempt (the
    residual and the pair total; a render that outgrew ``pair_cap`` is
    made again with a larger buffer). Returns (output, k_used, a pair
    buffer that held the last render's pairs)."""
    G = xyz.shape[0]
    cap = min(max_k or G, G)
    k = min(k_per_tile, cap)
    while True:
        out = render_gaussians(xyz, scales, quats, opacity, colors, valid,
                               w2c, K, img_hw=img_hw, tile=tile,
                               k_per_tile=k, pair_cap=pair_cap)
        resid, n_pairs = read_host(out.trunc_residual, out.n_pairs)
        if pair_cap is None:
            pair_cap = pair_bucket(n_pairs)     # for the next attempts
        elif n_pairs > pair_cap:
            pair_cap = pair_bucket(n_pairs)     # pairs dropped: again
            continue
        if k >= cap or resid <= residual_th:
            return out, k, pair_cap
        k = min(2 * k, cap)
