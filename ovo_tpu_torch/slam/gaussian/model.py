"""Fixed-capacity gaussian map state for the Gaussian-SLAM tier (port of
``ovo_tpu/slam/gaussian/model.py``).

The map is a preallocated struct of tensors with a ``valid`` mask: add =
prefix-sum append into free slots, prune = clearing valid bits, so the
optimizer state keeps its shape. Per-gaussian stable ``ids`` and instance
``obj_ids`` ride along through add / prune / densify, so the semantic side
sees the gaussian map as it sees the vanilla point map.

The reference's ``.at[dest].set(..., mode="drop")`` (dest = G drops the
row) is a scatter into one spare row past the end, cut off afterwards.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ...ops.knn import approx_knn_mean_dist

SH_C0 = 0.28209479177387814


@dataclasses.dataclass
class GaussianState:
    xyz: torch.Tensor            # (G, 3) f32 means (world)
    f_dc: torch.Tensor           # (G, 3) f32 SH DC coefficients
    scales_log: torch.Tensor     # (G, 3) f32 log-scales
    quats: torch.Tensor          # (G, 4) f32 wxyz rotations
    opacity_logit: torch.Tensor  # (G,)   f32 pre-sigmoid opacity
    ids: torch.Tensor            # (G,)   i32 stable point ids (-1 = free)
    obj_ids: torch.Tensor        # (G,)   i32 instance ids (-1 = unassigned)
    valid: torch.Tensor          # (G,)   bool live slots
    next_id: torch.Tensor        # ()     i32

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def _replace(self, **kw) -> "GaussianState":
        return dataclasses.replace(self, **kw)

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    # activations (the reference's get_* properties)
    def scales(self) -> torch.Tensor:
        return torch.exp(self.scales_log)

    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logit)

    def colors(self) -> torch.Tensor:
        """SH DC term -> RGB in [0, 1]."""
        return torch.clamp(SH_C0 * self.f_dc + 0.5, 0.0, 1.0)


def _unit_quats(n: int, device) -> torch.Tensor:
    q = torch.zeros((n, 4), dtype=torch.float32, device=device)
    q[:, 0] = 1.0
    return q


def init_gaussian_state(capacity: int, device="cpu") -> GaussianState:
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return GaussianState(
        xyz=torch.zeros((capacity, 3), **f32),
        f_dc=torch.zeros((capacity, 3), **f32),
        scales_log=torch.full((capacity, 3), -10.0, **f32),
        quats=_unit_quats(capacity, dev),
        opacity_logit=torch.full((capacity,), -10.0, **f32),
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        obj_ids=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        next_id=torch.zeros((), dtype=torch.int32, device=dev),
    )


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0


def _put(buf: torch.Tensor, dest: torch.Tensor, vals) -> torch.Tensor:
    """``buf`` with rows ``dest`` set to ``vals``; dest == len(buf) drops
    the row."""
    G = buf.shape[0]
    out = torch.cat([buf, buf[:1]])
    if not isinstance(vals, torch.Tensor):   # made on the device: no copy
        vals = torch.full((), vals, dtype=buf.dtype, device=buf.device)
    return out.index_copy_(0, dest, vals.expand(
        (dest.shape[0],) + buf.shape[1:]).contiguous())[:G]


def _slot_of_rank(free: torch.Tensor) -> torch.Tensor:
    """(G,) slot of the r-th free slot at r, G past the last free one."""
    G = free.shape[0]
    rank = torch.cumsum(free.to(torch.int32), 0) - 1
    src = torch.arange(G, dtype=torch.int32, device=free.device)
    out = torch.full((G + 1,), G, dtype=torch.int32, device=free.device)
    out.index_copy_(0, torch.where(free, rank, G).to(torch.int64), src)
    # the spare row took the writes of the slots in use: G again
    return torch.cat([out[:G], out.new_full((1,), G)])


def _dest(slot_of_rank: torch.Tensor, mask: torch.Tensor,
          rank: torch.Tensor) -> torch.Tensor:
    """Destination slot of each masked row (G when dropped)."""
    G = slot_of_rank.shape[0] - 1
    r = torch.where(mask & (rank < G), rank, G).to(torch.int64)
    return slot_of_rank[r].to(torch.int64)


def add_points(state: GaussianState, points: torch.Tensor,
               colors: torch.Tensor, new_mask: torch.Tensor
               ) -> GaussianState:
    """Seed gaussians at ``points[new_mask]`` into free slots in order,
    dropping overflow: scale init log(sqrt(mean 3-NN distance)) isotropic
    (among the incoming batch), opacity logit 0, identity rotation."""
    G = state.capacity
    slots = _slot_of_rank(~state.valid)
    order = torch.cumsum(new_mask.to(torch.int32), 0) - 1
    n_new = new_mask.to(torch.int32).sum()
    dest = _dest(slots, new_mask, order)
    nn = approx_knn_mean_dist(points, new_mask, k=3)
    scale = torch.log(torch.sqrt(torch.clamp(nn, min=1e-7)))[:, None] \
        .expand(-1, 3)
    n = points.shape[0]
    st = state
    return GaussianState(
        xyz=_put(st.xyz, dest, points.to(torch.float32)),
        f_dc=_put(st.f_dc, dest, rgb_to_sh(colors.to(torch.float32))),
        scales_log=_put(st.scales_log, dest, scale),
        quats=_put(st.quats, dest, _unit_quats(n, points.device)),
        opacity_logit=_put(st.opacity_logit, dest, 0.0),
        ids=_put(st.ids, dest, (st.next_id + order).to(torch.int32)),
        obj_ids=_put(st.obj_ids, dest, -1),
        valid=_put(st.valid, dest, True),
        next_id=(st.next_id + n_new).to(torch.int32),
    )


def prune_by_opacity(state: GaussianState, threshold: float,
                     protect_mask: Optional[torch.Tensor] = None
                     ) -> GaussianState:
    """Clear slots whose opacity fell below ``threshold``; ``protect_mask``
    keeps the slots it marks."""
    drop = state.valid & (torch.sigmoid(state.opacity_logit) < threshold)
    if protect_mask is not None:
        drop = drop & ~protect_mask
    return state._replace(valid=state.valid & ~drop,
                          ids=torch.where(drop, -1, state.ids),
                          obj_ids=torch.where(drop, -1, state.obj_ids))


def densify_clone_split(state: GaussianState, grad_avg: torch.Tensor,
                        grad_th: float, percent_dense: float, *,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None):
    """Gradient-magnitude densification. Gaussians whose accumulated
    positional-gradient magnitude exceeds ``grad_th`` densify: small ones
    (max scale <= percent_dense * the live set's bounding radius) CLONE (an
    exact copy appends), large ones SPLIT (the original goes, two samples
    of its own N(mean, scale) append with scales / 1.6). Appends fill free
    slots in order, dropping overflow. The samples' unit normal draws are
    ``noise`` (2, G, 3) when given (e.g. the reference's
    ``jax.random.normal(key, (2, G, 3))``), else drawn from ``generator``.

    Returns (new_state, appended (G,) bool): the slots whose Adam moments
    the caller zeroes (appends and removed split originals)."""
    G = state.capacity
    dev = state.device
    scales = state.scales()
    max_s = scales.amax(dim=-1)
    vn = torch.clamp(state.valid.sum(), min=1)
    centroid = (state.xyz * state.valid[:, None]).sum(0) / vn
    extent = torch.sqrt(torch.where(
        state.valid, ((state.xyz - centroid) ** 2).sum(-1), 0.0).amax())
    sel = state.valid & (grad_avg > grad_th)
    is_split = sel & (max_s > percent_dense * torch.clamp(extent, min=1e-6))

    w, x, y, z = state.quats.unbind(-1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)                                                  # (G, 3, 3)
    if noise is None:
        noise = torch.randn((2, G, 3), generator=generator,
                            device=generator.device if generator else dev)
    eps = noise.to(device=dev, dtype=torch.float32) * scales
    samp = (rot[None] * eps[:, :, None, :]).sum(-1) + state.xyz
    split_scales = state.scales_log - float(np.log(np.float32(1.6)))

    cand1_xyz = torch.where(is_split[:, None], samp[0], state.xyz)
    cand1_scl = torch.where(is_split[:, None], split_scales,
                            state.scales_log)
    valid2 = state.valid & ~is_split
    slots = _slot_of_rank(~valid2)
    n1 = sel.to(torch.int32).sum()
    rank1 = torch.cumsum(sel.to(torch.int32), 0) - 1
    rank2 = n1 + torch.cumsum(is_split.to(torch.int32), 0) - 1
    dest1 = _dest(slots, sel, rank1)
    dest2 = _dest(slots, is_split, rank2)
    n_new = n1 + is_split.to(torch.int32).sum()

    def put(buf, vals1, vals2):
        return _put(_put(buf, dest1, vals1), dest2, vals2)

    st = state
    out = GaussianState(
        xyz=put(st.xyz, cand1_xyz, samp[1]),
        f_dc=put(st.f_dc, st.f_dc, st.f_dc),
        scales_log=put(st.scales_log, cand1_scl, split_scales),
        quats=put(st.quats, st.quats, st.quats),
        opacity_logit=put(st.opacity_logit, st.opacity_logit,
                          st.opacity_logit),
        ids=put(st.ids, (st.next_id + rank1).to(torch.int32),
                (st.next_id + rank2).to(torch.int32)),
        obj_ids=put(st.obj_ids, st.obj_ids, st.obj_ids),
        valid=put(valid2, True, True),
        next_id=(st.next_id + n_new).to(torch.int32),
    )
    appended = put(torch.zeros_like(st.valid), True, True)
    return out, appended | (state.valid & ~valid2)


def n_valid(state: GaussianState) -> int:
    return int(state.valid.sum())


# --- checkpoint dicts (the reference's sem_gaussian_model capture layout) ---

def gaussian_map_dict(state: GaussianState) -> dict:
    """The live gaussians as numpy arrays (a host read)."""
    live = state.valid.cpu().numpy()
    idx = np.nonzero(live)[0]

    def host(t):
        return t.detach().cpu().numpy()[idx]

    f_dc = host(state.f_dc)
    return {
        "xyz": host(state.xyz),
        "obj_ids": host(state.obj_ids).reshape(-1, 1),
        "ids": host(state.ids).reshape(-1, 1),
        "max_id": int(state.next_id),
        "color": (np.clip(SH_C0 * f_dc + 0.5, 0, 1) * 255).astype(np.uint8),
        "f_dc": f_dc,
        "scales_log": host(state.scales_log),
        "quats": host(state.quats),
        "opacity_logit": host(state.opacity_logit),
    }


def from_gaussian_map_dict(d: dict, capacity: int,
                           device="cpu") -> GaussianState:
    """A state holding ``d``'s gaussians in its first rows (``d`` as
    :func:`gaussian_map_dict` gives it, from either package)."""
    xyz = np.asarray(d["xyz"], np.float32)
    n = xyz.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < checkpoint gaussians {n}")
    st = init_gaussian_state(capacity, device)

    def filled(buf, key, dt):
        out = buf.clone()
        out[:n] = torch.from_numpy(np.asarray(d[key], dt).reshape(
            (n,) + tuple(buf.shape[1:])).copy()).to(buf.device)
        return out

    valid = st.valid.clone()
    valid[:n] = True
    return GaussianState(
        xyz=filled(st.xyz, "xyz", np.float32),
        f_dc=filled(st.f_dc, "f_dc", np.float32),
        scales_log=filled(st.scales_log, "scales_log", np.float32),
        quats=filled(st.quats, "quats", np.float32),
        opacity_logit=filled(st.opacity_logit, "opacity_logit", np.float32),
        ids=filled(st.ids, "ids", np.int32),
        obj_ids=filled(st.obj_ids, "obj_ids", np.int32),
        valid=valid,
        next_id=torch.full((), int(d["max_id"]), dtype=torch.int32,
                           device=st.device),
    )


# --------------------------------------------------------------------------
# Gaussian PLY IO (the reference's 3DGS vertex layout: raw parameters as f4
# vertex properties, obj / stable ids included), binary little-endian,
# written and read without plyfile
# --------------------------------------------------------------------------

_PLY_PROPS = ("x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2",
              "opacity", "scale_0", "scale_1", "scale_2",
              "rot_0", "rot_1", "rot_2", "rot_3", "obj_0", "ids")


def save_gaussian_ply(state: GaussianState, path) -> None:
    """The live gaussians: raw (pre-activation) parameters, zero normals,
    instance id as obj_0 and stable id as ids, every property f4."""
    d = gaussian_map_dict(state)
    n = d["xyz"].shape[0]
    arr = np.zeros(n, dtype=[(p, "<f4") for p in _PLY_PROPS])
    arr["x"], arr["y"], arr["z"] = d["xyz"].T
    for i in range(3):
        arr[f"f_dc_{i}"] = d["f_dc"][:, i]
        arr[f"scale_{i}"] = d["scales_log"][:, i]
    arr["opacity"] = d["opacity_logit"].reshape(-1)
    for i in range(4):
        arr[f"rot_{i}"] = d["quats"][:, i]
    arr["obj_0"] = d["obj_ids"].reshape(-1).astype(np.float32)
    arr["ids"] = d["ids"].reshape(-1).astype(np.float32)
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {p}\n" for p in _PLY_PROPS)
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(arr.tobytes())


def load_gaussian_ply(path, capacity: int, device="cpu") -> GaussianState:
    """A gaussian ply written by :func:`save_gaussian_ply` (or any 3DGS ply
    of sh degree 0 with all-float properties) into a fresh state."""
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format") and \
                    "binary_little_endian" not in line:
                raise ValueError(f"unsupported ply format: {line}")
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, typ, name = line.split()
                if typ != "float":
                    raise ValueError(f"unsupported property type {typ}")
                props.append(name)
            elif line == "end_header":
                break
        arr = np.frombuffer(f.read(n * 4 * len(props)),
                            dtype=[(p, "<f4") for p in props])

    def col(*names):
        return np.stack([arr[p] for p in names], 1)

    d = {
        "xyz": col("x", "y", "z"),
        "f_dc": col("f_dc_0", "f_dc_1", "f_dc_2"),
        "scales_log": col("scale_0", "scale_1", "scale_2"),
        "quats": col("rot_0", "rot_1", "rot_2", "rot_3"),
        "opacity_logit": arr["opacity"],
        "obj_ids": (arr["obj_0"] if "obj_0" in props
                    else -np.ones(n, np.float32)).astype(np.int32),
        "ids": (arr["ids"] if "ids" in props
                else np.arange(n, dtype=np.float32)).astype(np.int32),
    }
    d["max_id"] = int(d["ids"].max()) + 1 if n else 0
    return from_gaussian_map_dict(d, capacity, device)
