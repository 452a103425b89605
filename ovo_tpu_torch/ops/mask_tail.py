"""The SAM decoder's mask tail in one kernel (B13) and its plain version.

Port of ``ovo_tpu/ops/mask_tail.py`` (``fused_mask_tail`` ->
``_mask_tail_kernel``): the second upscale (four 2x2 taps of a (c1, c2)
product with f32 accumulation), the cast to bf16, ``+ b2`` and ``+ hr0`` in
bf16, the tanh-gelu on bf16 and the f32 hypernetwork dot, written as compact
(B, 4, H*W*4, C) f32 logits; ``mask_tail_to_raster`` permutes them to (B, C,
4H, 4W) outside the kernel, as the reference does.

The tail is defined in bf16 only. Its gelu is the reference kernel's
literal op order, ``jax.nn.gelu(approximate=True)`` on bf16, with every
sub-op rounded to bf16 and both constants cast to bf16 first
(:func:`gelu_tanh_bf16`). ``F.gelu(approximate="tanh")`` on a bf16 tensor
computes in f32 and rounds once, which moves a gelu output by up to one
bf16 step; the decoder's other gelus keep it (``models/layers.gelu``).

The reference wires the kernel into no route (``ovo_tpu/models/sam/
decoder.py:438-442``); the port's decoder reaches it by name,
``decode_masks(..., mask_tail="fused")``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# jax.nn.gelu's constants 0.044715 and sqrt(2 / pi), cast to bf16 as JAX
# casts them for a bf16 input
_GELU_A = 0.044677734375
_GELU_S = 0.796875
MAX_CHANNELS = 4
# (c1, c2) the kernel is built for: SAM2's d = 256 decoder
KERNEL_WIDTHS = (64, 32)
# ovo_mask_tail(up1g, w2q, b2, hr0q, hyper, out, B, R, c1, c2, C)
_MASK_TAIL = cuda_build.Entry("mask_tail", "ovo_mask_tail",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5)


def gelu_tanh_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` on a bf16 tensor, each op
    rounded to bf16 in JAX's order: ``0.5 * (1 + tanh(sqrt(2/pi) * (x +
    0.044715 * x**3)))``, then ``x * cdf``. (A Python-float factor of a bf16
    tensor multiplies in f32 and rounds once, so the pre-rounded constants
    give JAX's bf16 products.)"""
    x3 = x * (x * x)
    cdf = 0.5 * (1.0 + torch.tanh(_GELU_S * (x + _GELU_A * x3)))
    return x * cdf


def fused_mask_tail_plain(up1g: torch.Tensor, w2q: torch.Tensor,
                          b2: torch.Tensor, hr0q: torch.Tensor,
                          hyper: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B13 (``_mask_tail_kernel``), per
    tap: f32 product, bf16 cast, + b2, + hr0q[tap] (each rounded), bf16
    tanh-gelu, f32 hypernet dot. -> (B, 4, R, C) f32."""
    hyp_t = hyper.float().transpose(1, 2)                    # (B, c2, C)
    taps = []
    for t in range(4):
        y = torch.matmul(up1g.float(), w2q[t].float()).to(torch.bfloat16)
        y = gelu_tanh_bf16(y + b2 + hr0q[t])
        taps.append(torch.matmul(y.float(), hyp_t))
    return torch.stack(taps, dim=1)


def fused_mask_tail(up1g: torch.Tensor, w2q: torch.Tensor, b2: torch.Tensor,
                    hr0q: torch.Tensor, hyper: torch.Tensor, *, H: int,
                    W: int) -> torch.Tensor:
    """up1g (B, H*W*4, c1) bf16, rows in (h, w, i, j) order (the first
    upscale's ``gelu(LN(.))``); w2q (4, c1, c2) the second upscale's taps,
    leading dim ``p * 2 + q``; b2 (c2,); hr0q (4, H*W*4, c2) the high-res
    skip gathered to (tap, row, channel); hyper (B, C, c2) the hypernet
    outputs. Returns (B, 4, H*W*4, C) f32 logits: pixel (4h + 2i + p, 4w +
    2j + q) at (b, p * 2 + q, (h, w, i, j), c).

    CPU tensors run :func:`fused_mask_tail_plain`; CUDA tensors launch
    kernel B13 (``csrc/mask_tail.cu``) or raise."""
    if up1g.dim() != 3 or w2q.dim() != 3 or w2q.shape[0] != 4:
        raise ValueError(f"fused_mask_tail: up1g (B, R, c1) and w2q (4, c1, "
                         f"c2) expected, got {tuple(up1g.shape)} / "
                         f"{tuple(w2q.shape)}")
    B, R, c1 = up1g.shape
    c2 = w2q.shape[2]
    C = hyper.shape[1]
    if (R != H * W * 4 or w2q.shape[1] != c1 or b2.shape != (c2,)
            or hr0q.shape != (4, R, c2) or hyper.shape != (B, C, c2)):
        raise ValueError(f"fused_mask_tail: inconsistent shapes up1g "
                         f"{tuple(up1g.shape)}, w2q {tuple(w2q.shape)}, b2 "
                         f"{tuple(b2.shape)}, hr0q {tuple(hr0q.shape)}, "
                         f"hyper {tuple(hyper.shape)} at H={H}, W={W}")
    tensors = (up1g, w2q, b2, hr0q, hyper)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("fused_mask_tail: the tail is defined in bf16 only")
    if up1g.device.type == "cpu":
        return fused_mask_tail_plain(up1g, w2q, b2, hr0q, hyper)
    dev = up1g.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"fused_mask_tail: inputs must share one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if (c1, c2) != KERNEL_WIDTHS or not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"fused_mask_tail takes (c1, c2) = {KERNEL_WIDTHS} "
                         f"and 1..{MAX_CHANNELS} channels; got ({c1}, {c2}), "
                         f"C={C}")
    if (not all(t.is_contiguous() for t in tensors) or up1g.data_ptr() % 16
            or any(t.data_ptr() % 4 for t in tensors)):
        raise ValueError("fused_mask_tail: inputs must be contiguous, up1g "
                         "16-byte aligned and the others 4-byte")
    out = torch.empty((B, 4, R, C), dtype=torch.float32, device=dev)
    err = _MASK_TAIL(dev.index, up1g.data_ptr(), w2q.data_ptr(),
                     b2.data_ptr(), hr0q.data_ptr(), hyper.data_ptr(),
                     out.data_ptr(), B, R, c1, c2, C)
    cuda_build.check(err, "mask_tail")
    cuda_build.count_launch("mask_tail")
    return out


def gather_hr0q(hr0: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The (4H, 4W, c2) raster high-res skip -> (4, H*W*4, c2) in the
    kernel's (tap, (h, w, i, j) row, channel) order."""
    c2 = hr0.shape[-1]
    return hr0.reshape(H, 2, 2, W, 2, 2, c2).permute(
        2, 5, 0, 3, 1, 4, 6).reshape(4, H * W * 4, c2)


def mask_tail_to_raster(masks4: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 4, H*W*4, C) kernel output -> raster (B, C, 4H, 4W) f32."""
    B, _, _, C = masks4.shape
    m = masks4.reshape(B, 2, 2, H, W, 2, 2, C)     # (b, p, q, h, w, i, j, c)
    m = m.permute(0, 7, 3, 5, 1, 4, 6, 2)          # (b, c, h, i, p, w, j, q)
    return m.reshape(B, C, 4 * H, 4 * W)
