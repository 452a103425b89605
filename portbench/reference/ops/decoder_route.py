"""Which route the SAM decoder's two-way transformer takes (port of the
choice at ``ovo_tpu/models/sam/decoder.py:258-262``).

The reference picks one of three routes by shape arithmetic on a TPU:

  - ``"proj_tail"``: the projection-fused cross attentions, t2i through
    kernel B3 and i2t with its out-projection, keys residual and norm4
    through kernel B4;
  - ``"proj"``: t2i through B3, i2t through B7 (``cross_i2t_from_keys``,
    the q projection folded in) and norm4 through B8;
  - ``"unfused"``: the image side projected with plain matmuls, token <->
    image attention through B9a / B9b (``cross_attention_small_head``) and
    norm4 through B8.

The predicates are the Pallas kernels' VMEM budgets, TPU-born limits that
mean nothing to a CUDA kernel. The port keeps them all the same: in bf16
the three routes round at different places (B3 rounds ``q Wk^T`` and
``p keys``, the unfused route rounds ``keys Wk + pe_k`` and ``keys Wv``),
so only the reference's own route gives the reference's numbers. The
functions below are copies of ``ovo_tpu/ops/attention.py:1049-1117``
(pure integer arithmetic), as ``hidden % chunk`` is kept for the fused
tower blocks.
"""
from __future__ import annotations

from typing import Optional

# the reference's per-kernel VMEM budget (``attention.py:45``)
VMEM_BUDGET = 12 * 1024 * 1024
ROUTES = ("proj_tail", "proj", "unfused")


def cross_proj_vmem_bytes(HT: int, L: int, D: int, dk: int,
                          itemsize: int) -> int:
    """Per-grid-step footprint of the TPU's projection-fused cross kernels
    (``attention.py:1101``): double-buffered keys, pe and token / output
    blocks, plus the (HT, L) f32 score tile, its exp and the cast tile."""
    io = 2 * itemsize * (L * dk + 2 * L * D + 2 * HT * D)
    inter = HT * L * (4 + 4 + itemsize)
    return io + inter


def cross_proj_fits(HT: int, L: int, D: int, dk: int, itemsize: int) -> bool:
    """``_cross_proj_fits`` (``attention.py:1113``)."""
    return (D == 128 and dk % 128 == 0 and HT % 8 == 0 and L % 128 == 0
            and cross_proj_vmem_bytes(HT, L, D, dk, itemsize)
            <= VMEM_BUDGET)


def cross_proj_ln_vmem_bytes(HT: int, BL: int, D: int, dk: int,
                             itemsize: int) -> int:
    """Per-grid-step footprint of the TPU's i2t tail kernel
    (``attention.py:1049``)."""
    io = 2 * itemsize * (2 * BL * dk + BL * D + 2 * HT * D)
    inter = HT * BL * (4 + 4 + itemsize) + 4 * BL * D + 2 * 4 * BL * dk
    weights = itemsize * (2 * dk * D) + 4 * 3 * dk
    return io + inter + weights


def cross_proj_ln_block(HT: int, L: int, D: int, dk: int,
                        itemsize: int) -> Optional[int]:
    """``_cross_proj_ln_block`` (``attention.py:1060``): the largest row
    block that divides L and fits the budget, or None."""
    for bl in (2048, 1024, 512, 256, 128):
        if L % bl == 0 and cross_proj_ln_vmem_bytes(
                HT, bl, D, dk, itemsize) <= VMEM_BUDGET:
            return bl
    return None


def cross_proj_ln_fits(HT: int, L: int, D: int, dk: int,
                       itemsize: int) -> bool:
    """``_cross_proj_ln_fits`` (``attention.py:1069``)."""
    return (D == 128 and dk % 128 == 0 and HT % 8 == 0
            and cross_proj_ln_block(HT, L, D, dk, itemsize) is not None)


def decoder_route(T: int, L: int, di: int, dk: int, heads: int,
                  itemsize: int) -> str:
    """The route of ``two_way_transformer`` for T tokens, L image rows, the
    cross attentions' internal width ``di``, the image width ``dk`` and the
    working dtype's ``itemsize``, as the reference decides it on a TPU.
    SAM2 Hiera-L at 1024^2 in bf16 takes ``"proj_tail"``; at 1280^2 (L
    6400) or in f32 it takes ``"unfused"``."""
    HT = heads * (T + (-T) % 8)
    if not cross_proj_fits(HT, L, di, dk, itemsize):
        return "unfused"
    if cross_proj_ln_fits(HT, L, di, dk, itemsize):
        return "proj_tail"
    return "proj"
