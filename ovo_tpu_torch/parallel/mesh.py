"""Process worlds, the (dp, tp) mesh and the tensor-parallel tower (port of
``ovo_tpu/parallel/mesh.py``).

The reference has one controller over a mesh of devices (``jax.shard_map``,
GSPMD). PyTorch's idiom is SPMD over processes: one rank per card (or CPU
process), launched by ``torchrun`` or ``torch.multiprocessing``; every rank
runs the same program on its own device, and explicit collectives take the
place of ``psum`` and of GSPMD's reshards. Axes, as in the reference:

  dp  -- keyframes (and scenes) split over ranks; encoders replicated
  tp  -- Megatron tensor parallelism inside a ViT tower: each rank holds a
         slice of the heads and of the MLP's hidden width, and sums the
         partial outputs with one ``all_reduce`` after ``attn.out`` and one
         after ``mlp.proj``
  point axis -- the map's rows split over dp for association
         (``parallel/shard.py``)

``nccl`` runs on the card and ``gloo`` on the CPU; the caller names the
backend and nothing switches quietly: ``nccl`` with a CPU tensor, or
``gloo`` with a card tensor, raises. Without an initialised process group
the world is one rank: the same code path, with trivial collectives.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models import layers as L

BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def init_world(backend: str, rank: int, world_size: int,
               init_method: str) -> torch.device:
    """Join the default process group; returns this rank's device (its card
    ``rank % device_count`` under ``nccl``, the CPU under ``gloo``)."""
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"backend must be one of {sorted(BACKEND_DEVICE)}, "
                         f"got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("nccl needs a CUDA card; use gloo on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return device


# every torch.distributed call that moves data between ranks
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "broadcast",
               "broadcast_object_list", "reduce", "gather", "scatter",
               "barrier", "send", "recv", "isend", "irecv")


@contextlib.contextmanager
def counting_collectives():
    """Counts, by name, the calls of :data:`COLLECTIVES` made while active
    (this package calls them through ``torch.distributed``'s attributes):
    the collectives-per-keyframe metric of the tests and the smoke run."""
    counts = collections.Counter()
    saved = {name: getattr(dist, name) for name in COLLECTIVES
             if hasattr(dist, name)}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass
class Mesh:
    """A (dp, tp) grid of ranks, rank = dp_index * tp + tp_index, with this
    rank's process group along each axis (``None``: the world is one rank
    and there is no process group)."""
    shape: Tuple[int, int]
    axis_names: Tuple[str, str]
    rank: int
    groups: Dict[str, Optional[dist.ProcessGroup]]
    backend: Optional[str]

    @classmethod
    def single(cls, axis_names: Tuple[str, str] = ("dp", "tp")) -> "Mesh":
        """A world of one, whatever process group exists: its collectives
        are trivial."""
        return cls((1, 1), tuple(axis_names), 0, dict.fromkeys(axis_names),
                   None)

    @property
    def devices(self) -> np.ndarray:
        """The ranks laid out as the grid (the reference's device array)."""
        return np.arange(self.shape[0] * self.shape[1]).reshape(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str, rank: Optional[int] = None) -> int:
        """The coordinate along ``axis`` of ``rank`` (default: this
        rank)."""
        i, j = divmod(self.rank if rank is None else rank, self.shape[1])
        return (i, j)[self.axis_names.index(axis)]

    def check_device(self, device) -> None:
        """Raise unless ``device`` is the backend's (nccl: a card, gloo: the
        CPU)."""
        want = BACKEND_DEVICE.get(self.backend)
        if want is not None and torch.device(device).type != want:
            raise ValueError(f"the {self.backend} backend takes {want} "
                             f"tensors, got {torch.device(device)}")

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """In-place sum of ``t`` over ``axis``; returns ``t``."""
        if self.backend is not None:
            self.check_device(t.device)
            dist.all_reduce(t, group=self.groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ``axis`` ranks' ``t`` (equal shapes) concatenated along dim 0
        in rank order."""
        if self.backend is None:
            return t
        self.check_device(t.device)
        parts = [torch.empty_like(t) for _ in range(self.size(axis))]
        dist.all_gather(parts, t.contiguous(), group=self.groups[axis])
        return torch.cat(parts)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("dp", "tp")) -> Mesh:
    """The world's ranks as a (dp, tp) grid. Default shape: favour dp, tp 2
    when the rank count is even and at least 4 (the reference's rule). Every
    rank must call this in the same order: it creates the axes' groups
    collectively."""
    n = world_size()
    if shape is None:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
        shape = (n // tp, tp)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh {shape} != {n} ranks")
    rank = world_rank()
    groups: Dict[str, Optional[dist.ProcessGroup]] = dict.fromkeys(
        axis_names)
    backend = None
    if dist.is_initialized():
        backend = dist.get_backend()
        grid = np.arange(n).reshape(shape)
        for name, lines in ((axis_names[0], grid.T), (axis_names[1], grid)):
            for line in lines:
                ranks = line.tolist()
                # an axis that spans the world is the default group
                g = (dist.group.WORLD if len(ranks) == n
                     else dist.new_group(ranks))
                if rank in ranks:
                    groups[name] = g
    return Mesh(tuple(shape), tuple(axis_names), rank, groups, backend)


def dp_average_gradients(mesh: Mesh, axis: str = "dp"):
    """A train step's ``grad_hook`` (``models/merger.make_train_step``)
    that averages every parameter's gradient over ``axis``: the gradients
    flattened into one buffer, ONE ``all_reduce``, divided by the axis
    size, copied back."""
    def hook(params: nn.Module) -> None:
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.all_reduce(flat, axis).div_(mesh.size(axis))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    return hook


# ---------------------------------------------------------------------------
# tensor parallelism inside a ViT tower (Megatron layout)
# ---------------------------------------------------------------------------

def tp_shard_tower(model: nn.Module, mesh: Mesh, rank: int,
                   tp_axis: str = "tp") -> nn.Module:
    """A copy of a ViT tower (``models/vit.VisionTransformer``) holding
    ``rank``'s tensor-parallel slice of every block: qkv and ``mlp.fc``
    split by output, ``attn.out`` and ``mlp.proj`` split by input. q, k and
    v are each split by head, so the rank's packed qkv is a whole
    ``(3, heads / tp, hd)`` block. The biases of ``attn.out`` and
    ``mlp.proj`` move to ``out_bias`` / ``proj_bias``: they are added once,
    after the reduction (:func:`tp_transformer_block`). Everything else is
    replicated."""
    tp, t = mesh.size(tp_axis), mesh.index(tp_axis, rank)
    shard = copy.deepcopy(model)
    for blk in shard.blocks:
        D = blk.attn.qkv.w.shape[0]
        if blk.n_heads % tp or D % tp:
            raise ValueError(f"{blk.n_heads} heads of width {D} do not "
                             f"split over tp {tp}")
        dl = D // tp
        cols = torch.cat([torch.arange(s * D + t * dl, s * D + (t + 1) * dl)
                          for s in range(3)])
        hid = blk.mlp.fc.w.shape[1] // tp
        rows = slice(t * hid, (t + 1) * hid)
        with torch.no_grad():
            qkv, out, fc, proj = (blk.attn.qkv, blk.attn.out, blk.mlp.fc,
                                  blk.mlp.proj)
            qkv.w = nn.Parameter(qkv.w[:, cols].contiguous(),
                                 requires_grad=False)
            qkv.b = nn.Parameter(qkv.b[cols].contiguous(),
                                 requires_grad=False)
            blk.attn.out_bias, out.b = out.b, None
            out.w = nn.Parameter(out.w[t * dl:(t + 1) * dl].contiguous(),
                                 requires_grad=False)
            fc.w = nn.Parameter(fc.w[:, rows].contiguous(),
                                requires_grad=False)
            fc.b = nn.Parameter(fc.b[rows].contiguous(), requires_grad=False)
            blk.mlp.proj_bias, proj.b = proj.b, None
            proj.w = nn.Parameter(proj.w[rows].contiguous(),
                                  requires_grad=False)
    return shard


def tp_transformer_block(p: L.Block, x: torch.Tensor, n_heads: int,
                         rope=None, causal: bool = False,
                         attn_impl: str = "auto", act: str = "gelu",
                         n_valid: Optional[int] = None, *, mesh: Mesh,
                         tp_axis: str = "tp") -> torch.Tensor:
    """``layers.transformer_block`` on a :func:`tp_shard_tower` block: each
    half's partial output is summed over ``tp_axis`` (one ``all_reduce``
    each), then its bias is added once."""
    h = L.multi_head_attention(p.attn, p.ln1(x), n_heads, rope=rope,
                               causal=causal, attn_impl=attn_impl,
                               n_valid=n_valid)
    h = mesh.all_reduce(h, tp_axis) + p.attn.out_bias.to(h.dtype)
    if p.ls1 is not None:
        h = h * p.ls1.to(h.dtype)
    x = x + h
    h = L.mlp(p.mlp, p.ln2(x), act=L.ACTS[act])
    h = mesh.all_reduce(h, tp_axis) + p.mlp.proj_bias.to(h.dtype)
    if p.ls2 is not None:
        h = h * p.ls2.to(h.dtype)
    return x + h


@torch.no_grad()
def tp_encode(shard: nn.Module, cfg, imgs: torch.Tensor, mesh: Mesh,
              tp_axis: str = "tp") -> torch.Tensor:
    """``vit.encode`` through a tensor-parallel shard: every rank of a tp
    group passes the same images and gets the whole pooled embedding."""
    import functools

    from ..models import vit

    block = functools.partial(tp_transformer_block, mesh=mesh,
                              tp_axis=tp_axis)
    return vit.encode(shard, cfg, imgs, block_fn=block)
