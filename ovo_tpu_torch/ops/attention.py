"""Attention for the towers and the SAM decoder: plain references and the
hand-written kernels B1-B5, B7, B9a / B9b, B10 and B11.

Port of the parts of ``ovo_tpu/ops/attention.py`` the port's slices run:

  - ``xla_attention``: plain softmax attention, the reference semantics
    (``attention.py:92-105``), and the route of causal, masked and
    head-size > 128 attention on either device;
  - ``rope_packed_attention`` (B5): packed-qkv attention with in-kernel
    rotate-half RoPE and token-major output (``attention.py:326-366``);
  - ``fused_attention`` (B10, ``:218``), ``flash_attention`` (B1, ``:155``)
    and ``windowed_fused_attention`` (B2, ``:395``) behind
    ``dot_product_attention``, for the CLIP / SigLIP towers, the Hiera trunk,
    the text towers and the decoder's token self-attention;
  - ``packed_heads_attention`` (B11, ``:499``): window attention on the
    head-packed (B, L, heads * hd) layout, the Hiera trunk's window blocks
    under ``window_attn="packed"``;
  - ``cross_t2i_from_keys`` (B3, ``:1120``), ``cross_i2t_tail_from_keys``
    (B4, ``:1075``) and ``cross_i2t_from_keys`` (B7, ``:1143``): the
    decoder's projection-fused cross attentions;
  - ``cross_attention_small_head`` (B9a t2i / B9b i2t, ``:1166``): the
    decoder's token <-> image attention on pre-projected operands.

Every kernel wrapper launches its kernel (``csrc/<name>.cu``) on a CUDA
tensor, or raises on what the kernel does not take; on a CPU tensor it runs
its ``*_plain`` version beside it, the same function in PyTorch ops with the
reference's roundings. The TPU's routing rules (VMEM budgets, sublane pads)
do not carry over: the CUDA kernels take any length and head size up to
128 natively, so the wrappers pad nothing but B10's bf16 operands at a head
size B2's device code is not built for.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Lq, D), (B, H, Lk, D) -> (B, H, Lq, D). ``mask`` broadcastable
    to (B, H, Lq, Lk), True = attend. Scores, softmax and the p.v sum in f32
    (the reference's preferred_element_type), p rounded to v's dtype."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate-half RoPE on x (..., L, D) in x's dtype (layers.apply_rope)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos.to(x.dtype)
    s = sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def use_rope_packed(hd: int, dtype: torch.dtype) -> bool:
    """Can ``rope_packed_attention`` take this layer (head size a multiple
    of 16 up to 128, f32 or bf16)?"""
    return hd % 16 == 0 and 16 <= hd <= 128 and dtype in _DTYPES


def _check_rope_args(qkv, cos, sin, heads, kv_len):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, L, 3D), got {tuple(qkv.shape)}")
    B, L, three_d = qkv.shape
    D = three_d // 3
    if heads <= 0 or D % heads:
        raise ValueError(f"D={D} does not split into {heads} heads")
    hd = D // heads
    if cos.shape != (L, hd // 2) or sin.shape != (L, hd // 2):
        raise ValueError(f"RoPE tables must be ({L}, {hd // 2}), got "
                         f"{tuple(cos.shape)} / {tuple(sin.shape)}")
    kv = L if kv_len is None else int(kv_len)
    if not 1 <= kv <= L:
        raise ValueError(f"kv_len {kv} outside [1, {L}]")
    return B, L, D, hd, kv


def rope_packed_attention_plain(qkv: torch.Tensor, cos: torch.Tensor,
                                sin: torch.Tensor, *, heads: int,
                                scale: Optional[float] = None,
                                kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel B5: split heads, RoPE in the working
    dtype, f32 scores with ``scale`` after the dot, keys >= kv_len at -1e30,
    f32 softmax, p rounded to the dtype, f32 p.v, output (B, L, D)."""
    B, L, D, hd, kv = _check_rope_args(qkv, cos, sin, heads, kv_len)
    scale = scale if scale is not None else hd ** -0.5

    def split(t):
        return t.reshape(B, L, heads, hd).transpose(1, 2)

    q, k, v = (split(t) for t in qkv.split(D, dim=-1))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    mask = None
    if kv < L:
        mask = (torch.arange(L, device=qkv.device) < kv)[None, None, None, :]
    o = xla_attention(q, k, v, mask=mask, scale=scale)
    return o.transpose(1, 2).reshape(B, L, D)


def rope_packed_attention(qkv: torch.Tensor, cos: torch.Tensor,
                          sin: torch.Tensor, *, heads: int,
                          scale: Optional[float] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """(B, L, 3D) packed qkv + (L, hd/2) f32 RoPE tables -> (B, L, D)
    attention output, token-major. Keys at or past ``kv_len`` (default L)
    are masked: a caller that pre-pads the token stream once for the whole
    tower passes the real token count.

    CPU tensors run :func:`rope_packed_attention_plain`; CUDA tensors launch
    kernel B5 (``csrc/rope_packed_attention.cu``) or raise."""
    if qkv.device.type == "cpu":
        return rope_packed_attention_plain(qkv, cos, sin, heads=heads,
                                           scale=scale, kv_len=kv_len)
    B, L, D, hd, kv = _check_rope_args(qkv, cos, sin, heads, kv_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if not use_rope_packed(hd, qkv.dtype):
        raise ValueError(f"kernel takes f32/bf16 with hd % 16 == 0, hd <= "
                         f"128; got {qkv.dtype}, hd={hd}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.device != qkv.device:
            raise ValueError(f"{name} must be f32 on {qkv.device}")
    if not (qkv.is_contiguous() and cos.is_contiguous()
            and sin.is_contiguous()):
        raise ValueError("rope_packed_attention needs contiguous inputs")
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty((B, L, D), dtype=qkv.dtype, device=qkv.device)
    # bf16: the rotated q and k, written once by the kernel's first launch
    rot = torch.empty((2, B, L, D) if qkv.dtype == torch.bfloat16 else (0,),
                      dtype=qkv.dtype, device=qkv.device)
    lib = cuda_build.library("rope_packed_attention")
    fn = lib.ovo_rope_packed_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                 rot.data_ptr(), out.data_ptr(), B, L, D, heads, kv,
                 float(scale), _DTYPES[qkv.dtype], stream)
    cuda_build.check(err, "rope_packed_attention")
    cuda_build.count_launch("rope_packed_attention")
    return out


# ---------------------------------------------------------------------------
# B10 / B1 / B2: self-attention on (B, H, L, D) -- the CLIP / SigLIP towers,
# the Hiera trunk, the text towers and the SAM decoder's token self-attention
# ---------------------------------------------------------------------------

WINDOWED_MAX_LEN = 512
WINDOWED_HEAD_DIMS = (16, 32, 48, 56, 64, 72, 80, 96, 112, 128)
FUSED_MIN_LEN, FUSED_MAX_LEN = 256, 1024
MAX_HEAD_DIM = 128


def attention_route(lq: int, lk: int, d: int, *, causal: bool = False,
                    has_mask: bool = False) -> str:
    """What runs a (.., lq, d) x (.., lk, d) self-attention, a pure function
    of the shapes (CPU tensors take the same route to the kernel's plain
    version):

      - ``"xla"``: causal, masked or d > 128 -- :func:`xla_attention` on
        either device (the reference routes these to XLA too, no Pallas
        kernel: the causal text towers and the merger's head size 144);
      - ``"fused"`` (B10): lq == lk in [256, 1024] -- the CLIP / SigLIP image
        towers (JAX's route there, ``select_attention_route``, at any batch:
        its bh <= 512 gate is a TPU grid limit);
      - ``"windowed"`` (B2): both lengths at most 512 -- windows, text
        towers, the decoder's tokens;
      - ``"flash"`` (B1): the rest, long sequences with streamed keys."""
    if causal or has_mask or d > MAX_HEAD_DIM:
        return "xla"
    if lq == lk and FUSED_MIN_LEN <= lq <= FUSED_MAX_LEN:
        return "fused"
    return ("windowed" if lq <= WINDOWED_MAX_LEN and lk <= WINDOWED_MAX_LEN
            else "flash")


def _keys_below(lk: int, kv_len: Optional[int], device) -> Optional[
        torch.Tensor]:
    if kv_len is None or kv_len >= lk:
        return None
    return torch.arange(lk, device=device) < kv_len


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (``_flash_kernel``): q scaled in
    f32 before the dot, keys >= kv_len at -1e30, f32 softmax whose weights
    stay f32 (the streaming kernel never rounds them), f32 p.v, output in
    q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    keep = _keys_below(k.shape[-2], kv_len, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def windowed_attention_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: Optional[float] = None,
                             kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of kernels B2 (``_winfused_kernel``) and B10
    (``_fused_kernel``): f32 scores with ``scale`` after the dot, keys >=
    kv_len at -1e30, f32 softmax, p rounded to v's dtype, f32 p.v, output in
    q's dtype."""
    keep = _keys_below(k.shape[-2], kv_len, q.device)
    return xla_attention(q, k, v, mask=keep, scale=scale)


# B10 computes B2's function in B2's op order; only the tiling differs
fused_attention_plain = windowed_attention_plain


def _check_self_args(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, H, L, D) with k.shape == "
                         f"v.shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Lq, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    Lk = k.shape[2]
    kv = Lk if kv_len is None else int(kv_len)
    if not 1 <= kv <= Lk:
        raise ValueError(f"kv_len {kv} outside [1, {Lk}]")
    return B, H, Lq, Lk, D, kv


def _check_device_tensors(name, tensors, dtype=None):
    """Every tensor on one CUDA device in one kernel dtype (f32 / bf16)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    dtype = dtype or tensors[0].dtype
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: kernel takes float32 or bfloat16, got "
                         f"{dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: inputs must share device {dev} and "
                             f"dtype {dtype}; got {t.device}, {t.dtype}")
    return dev, dtype


def _launch_self(name, symbol, q, k, v, kv, scale):
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    dev, dtype = _check_device_tensors(name, (q, k, v))
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {n} needs a contiguous last dim, got "
                             f"strides {t.stride()}")
    # token-major output: the caller's (B, H, L, D) -> (B, L, H*D) merge of
    # the heads is then a view
    out = torch.empty((B, Lq, H, D), dtype=dtype, device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = getattr(cuda_build.library(name), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 H, Lq, Lk, D, kv, float(scale), _DTYPES[dtype], strides,
                 stream)
    cuda_build.check(err, name)
    cuda_build.count_launch(name)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D) streaming-softmax attention (B1). Keys
    at or past ``kv_len`` (default Lk) are masked. Any (batch, head, row)
    strides with a contiguous last dim, head size up to 128; the output is a
    (B, H, Lq, D) view of token-major memory.

    CPU tensors run :func:`flash_attention_plain`; CUDA tensors launch
    kernel B1 (``csrc/flash_attention.cu``) or raise."""
    B, H, Lq, Lk, D, kv = _check_self_args(q, k, v, kv_len)
    scale = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, kv_len=kv_len)
    if not 1 <= D <= 128:
        raise ValueError(f"flash_attention: head size {D} outside [1, 128]")
    return _launch_self("flash_attention", "ovo_flash_attention", q, k, v, kv,
                        scale)


def windowed_fused_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             scale: Optional[float] = None,
                             kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention over many small (B*H) instances of (Lq, D) x (Lk, D), both
    lengths at most 512 (B2). Keys at or past ``kv_len`` are masked; an
    all-zero instance softmaxes to uniform (the mean of v), never NaN. Head
    sizes in ``WINDOWED_HEAD_DIMS``; strides as :func:`flash_attention`.

    CPU tensors run :func:`windowed_attention_plain`; CUDA tensors launch
    kernel B2 (``csrc/windowed_attention.cu``) or raise."""
    B, H, Lq, Lk, D, kv = _check_self_args(q, k, v, kv_len)
    scale = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return windowed_attention_plain(q, k, v, scale=scale, kv_len=kv_len)
    if max(Lq, Lk) > WINDOWED_MAX_LEN or D not in WINDOWED_HEAD_DIMS:
        raise ValueError(f"windowed_fused_attention takes Lq, Lk <= "
                         f"{WINDOWED_MAX_LEN} and D in {WINDOWED_HEAD_DIMS}; "
                         f"got Lq={Lq}, Lk={Lk}, D={D}")
    return _launch_self("windowed_attention", "ovo_windowed_attention", q, k,
                        v, kv, scale)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Whole-KV attention (B10): (B, H, Lq, D) x (B, H, Lk, D), Lk at most
    1024, head size up to 128, any batch. Keys at or past ``kv_len``
    (default Lk) are masked. Strides and output as :func:`flash_attention`
    (in bf16, a head size outside ``WINDOWED_HEAD_DIMS`` is padded with zero
    columns, a copy, and the output is a view of the padded result).

    CPU tensors run :func:`fused_attention_plain`; CUDA tensors launch
    kernel B10 (``csrc/fused_attention.cu``) or raise."""
    B, H, Lq, Lk, D, kv = _check_self_args(q, k, v, kv_len)
    scale = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, scale=scale, kv_len=kv_len)
    if Lk > FUSED_MAX_LEN or not 1 <= D <= MAX_HEAD_DIM or B * H > 65535:
        raise ValueError(f"fused_attention takes Lk <= {FUSED_MAX_LEN}, head "
                         f"size <= {MAX_HEAD_DIM} and B*H <= 65535; got "
                         f"Lk={Lk}, D={D}, B*H={B * H}")
    pad = 0
    if q.dtype == torch.bfloat16 and D not in WINDOWED_HEAD_DIMS:
        # bf16 runs B2's device code, built for its head sizes: zero columns
        # add nothing to q . k, and the output's extra columns are dropped
        pad = min(d for d in WINDOWED_HEAD_DIMS if d > D) - D
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    out = _launch_self("fused_attention", "ovo_fused_attention", q, k, v, kv,
                       scale)
    return out[..., :D] if pad else out


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          causal: bool = False) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D) as
    :func:`attention_route` picks: kernel B10, B2 or B1, or -- causal,
    masked (``mask`` broadcastable to (B, H, Lq, Lk), True = attend) or head
    size above 128 -- :func:`xla_attention`, on either device."""
    route = attention_route(q.shape[-2], k.shape[-2], q.shape[-1],
                            causal=causal, has_mask=mask is not None)
    if route == "xla":
        if causal and mask is None:
            lq, lk = q.shape[-2], k.shape[-2]
            mask = torch.ones((lq, lk), dtype=torch.bool,
                              device=q.device).tril()[None, None]
        return xla_attention(q, k, v, mask=mask, scale=scale)
    if route == "fused":
        return fused_attention(q, k, v, scale=scale)
    if route == "windowed":
        return windowed_fused_attention(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale)


# ---------------------------------------------------------------------------
# B11: window attention on the head-packed layout
# ---------------------------------------------------------------------------

def use_packed_heads(lq: int, lk: int, dout: int, heads: int) -> bool:
    """The reference's gate of ``packed_heads_attention``
    (``ovo_tpu/ops/attention.py:541``) less its TPU terms (the backend test
    and the VMEM block budget): heads of a width that is a multiple of 8,
    both lengths at most 512."""
    return (dout % heads == 0 and (dout // heads) % 8 == 0
            and lq <= WINDOWED_MAX_LEN and lk <= WINDOWED_MAX_LEN)


def packed_heads_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, heads: int,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of kernel B11 (``_packed_heads_kernel``): per
    head, f32 scores with ``scale`` after the dot, f32 softmax, p rounded to
    v's dtype, f32 p.v, each head rounded to q's dtype in its columns."""
    B, Lq, dout = q.shape
    hd = dout // heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)

    o = xla_attention(split(q), split(k), split(v), scale=scale)
    return o.transpose(1, 2).reshape(B, Lq, dout)


def packed_heads_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, heads: int, scale: Optional[float] = None
                           ) -> torch.Tensor:
    """(B, Lq, heads*hd) x (B, Lk, heads*hd) head-packed attention -> (B,
    Lq, heads*hd) (B11): many small instances, both lengths at most 512, Lq
    and Lk may differ. Any batch and row strides with a contiguous last dim
    (the q, k, v column slices of a packed qkv projection are read in
    place); head sizes in ``WINDOWED_HEAD_DIMS`` on the card.

    CPU tensors run :func:`packed_heads_attention_plain`; CUDA tensors
    launch kernel B11 (``csrc/packed_heads_attention.cu``) or raise."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"packed_heads_attention: q (B, Lq, D), k == v (B, "
                         f"Lk, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, dout = q.shape
    Lk = k.shape[1]
    if k.shape[0] != B or k.shape[2] != dout or heads < 1 or dout % heads:
        raise ValueError(f"packed_heads_attention: k {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)} with {heads} heads")
    hd = dout // heads
    scale = scale if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return packed_heads_attention_plain(q, k, v, heads=heads, scale=scale)
    dev, dtype = _check_device_tensors("packed_heads_attention", (q, k, v))
    if max(Lq, Lk) > WINDOWED_MAX_LEN or hd not in WINDOWED_HEAD_DIMS:
        raise ValueError(f"packed_heads_attention takes Lq, Lk <= "
                         f"{WINDOWED_MAX_LEN} and head sizes in "
                         f"{WINDOWED_HEAD_DIMS}; got Lq={Lq}, Lk={Lk}, "
                         f"hd={hd}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"packed_heads_attention: {n} needs a contiguous "
                             f"last dim, got strides {t.stride()}")
    out = torch.empty((B, Lq, dout), dtype=dtype, device=dev)
    fn = cuda_build.library(
        "packed_heads_attention").ovo_packed_heads_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_longlong] * 6 + [ctypes.c_int,
                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 Lq, Lk, dout, heads, float(scale), q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                 _DTYPES[dtype], stream)
    cuda_build.check(err, "packed_heads_attention")
    cuda_build.count_launch("packed_heads_attention")
    return out


# ---------------------------------------------------------------------------
# B3 / B4: the SAM decoder's projection-fused cross attentions
# ---------------------------------------------------------------------------

CROSS_MAX_ROWS = 64      # heads * tokens
CROSS_MAX_TOKENS = 16    # B4's tokens per head
CROSS_MAX_DK = 256
# D at most in bf16 (the tensor-core kernels' shared-memory tiles): B3; B4
# and B7
T2I_MAX_D_BF16 = 256
I2T_MAX_D_BF16 = 128


def _heads_w(w: torch.Tensor, heads: int) -> torch.Tensor:
    """(dk, D) weight -> (dk, heads, dh) f32."""
    return w.float().reshape(w.shape[0], heads, -1)


def cross_t2i_from_keys_plain(q_proj: torch.Tensor, keys: torch.Tensor,
                              wk: torch.Tensor, wv: torch.Tensor,
                              pe_k: torch.Tensor, bv: torch.Tensor,
                              heads: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B3 (``_crossq_proj_kernel``), per
    head: qk = q_h Wk_h^T rounded to the dtype; s = (qk keys^T + q_h pe_k_h^T)
    * scale in f32; softmax over L, p rounded to the dtype; pk = p keys
    rounded; out = pk Wv_h + bv_h, in q's dtype."""
    dt = keys.dtype
    Bq, T, D = q_proj.shape
    L, dk = keys.shape[1], keys.shape[2]
    dh = D // heads
    qh = q_proj.float().reshape(Bq, T, heads, dh)
    qk = torch.einsum("bthj,chj->bhtc", qh, _heads_w(wk.to(dt), heads))
    qk = qk.to(q_proj.dtype).float()                          # (Bq, h, T, dk)
    kf = keys.float()[:, None]                                # (Bk, 1, L, dk)
    s = torch.matmul(qk, kf.transpose(-1, -2))                # (B, h, T, L)
    pe = pe_k.to(dt).float().reshape(L, heads, dh)
    s = (s + torch.einsum("bthj,lhj->bhtl", qh, pe)) * dh ** -0.5
    p = torch.softmax(s, dim=-1).to(dt).float()
    pk = torch.matmul(p, kf).to(dt).float()                   # (B, h, T, dk)
    o = torch.einsum("bhtc,chj->bthj", pk, _heads_w(wv.to(dt), heads))
    o = o + bv.float().reshape(heads, dh)
    return o.reshape(o.shape[0], T, D).to(q_proj.dtype)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it in a fresh (16-byte aligned) allocation when its
    data pointer is not: for the kernels' 16-byte loads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _batch_stride(t: torch.Tensor) -> int:
    """A batch-1 operand is shared: stride 0."""
    return t.stride(0) if t.shape[0] > 1 else 0


def _check_cross_batches(name, B, *tensors):
    for t in tensors:
        if t.shape[0] not in (1, B):
            raise ValueError(f"{name}: batch {t.shape[0]} is neither 1 nor "
                             f"{B}")
        if not t[0].is_contiguous():
            raise ValueError(f"{name}: each batch entry must be contiguous, "
                             f"got strides {t.stride()}")


def cross_t2i_from_keys(q_proj: torch.Tensor, keys: torch.Tensor,
                        wk: torch.Tensor, wv: torch.Tensor,
                        pe_k: torch.Tensor, bv: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """Token -> image cross attention reading the raw keys stream (B3):
    q_proj (B or 1, T, D) projected tokens, keys (B or 1, L, dk), wk / wv
    (dk, D), pe_k (1, L, D) = image_pe Wk + bk, bv (D,) -> (B, T, D)
    pre-out-projection, in q's dtype. Batch-1 operands are shared, never
    broadcast in memory.

    CPU tensors run :func:`cross_t2i_from_keys_plain`; CUDA tensors launch
    kernel B3 (``csrc/cross_t2i.cu``) or raise."""
    if q_proj.dim() != 3 or keys.dim() != 3:
        raise ValueError("q_proj and keys must be (B, T, D) / (B, L, dk)")
    B = max(q_proj.shape[0], keys.shape[0])
    _, T, D = q_proj.shape
    L, dk = keys.shape[1], keys.shape[2]
    if (D % heads or wk.shape != (dk, D) or wv.shape != (dk, D)
            or pe_k.numel() != L * D or bv.shape != (D,)):
        raise ValueError(f"cross_t2i_from_keys: inconsistent shapes q "
                         f"{tuple(q_proj.shape)}, keys {tuple(keys.shape)}, "
                         f"wk {tuple(wk.shape)}, pe_k {tuple(pe_k.shape)}")
    if keys.device.type == "cpu":
        return cross_t2i_from_keys_plain(q_proj, keys, wk, wv, pe_k, bv,
                                         heads)
    dev, dt = _check_device_tensors("cross_t2i", (q_proj, keys))
    if heads * T > CROSS_MAX_ROWS or dk % 16 or dk > CROSS_MAX_DK:
        raise ValueError(f"cross_t2i takes heads*T <= {CROSS_MAX_ROWS}, "
                         f"dk % 16 == 0, dk <= {CROSS_MAX_DK}; got heads="
                         f"{heads}, T={T}, dk={dk}")
    if dt == torch.bfloat16 and D > T2I_MAX_D_BF16:
        raise ValueError(f"cross_t2i takes D <= {T2I_MAX_D_BF16} in bf16, "
                         f"got {D}")
    _check_cross_batches("cross_t2i", B, q_proj, keys)
    if dt == torch.float32:
        keys = _aligned16(keys)  # the f32 kernel reads keys 16 bytes a load
    wk, wv = wk.to(dt).contiguous(), wv.to(dt).contiguous()
    pe = pe_k.to(dt).reshape(L, D).contiguous()
    bvf = bv.float().contiguous()
    for t in (wk, wv, pe, bvf):
        if t.device != dev:
            raise ValueError(f"cross_t2i: weights must be on {dev}")
    out = torch.empty((B, T, D), dtype=dt, device=dev)
    fn = cuda_build.library("cross_t2i").ovo_cross_t2i
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q_proj.data_ptr(), keys.data_ptr(), wk.data_ptr(),
                 wv.data_ptr(), pe.data_ptr(), bvf.data_ptr(), out.data_ptr(),
                 B, T, heads, L, dk, D, float((D // heads) ** -0.5),
                 _batch_stride(q_proj), _batch_stride(keys),
                 _DTYPES[dt], stream)
    cuda_build.check(err, "cross_t2i")
    cuda_build.count_launch("cross_t2i")
    return out


def cross_i2t_from_keys_plain(keys: torch.Tensor, wq: torch.Tensor,
                              pe_q: torch.Tensor, kk_tok: torch.Tensor,
                              vv_tok: torch.Tensor, heads: int,
                              t_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel B7 (``_crossk_proj_kernel``), in the
    reference's types: kq = k_h Wq_h^T rounded; s = (kq keys^T + k_h
    pe_q_h^T) * scale in f32, tokens >= t_len at -1e30; softmax over the
    tokens of each head, p rounded; out = p v in f32, in keys' dtype."""
    dt = keys.dtype
    L = keys.shape[1]
    Bt, T, D = kk_tok.shape
    B = max(keys.shape[0], Bt)
    dh = D // heads
    kh = kk_tok.float().reshape(Bt, T, heads, dh)
    kq = torch.einsum("bthj,chj->bhtc", kh, _heads_w(wq.to(dt), heads))
    kq = kq.to(dt).float()                                    # (Bt, h, T, dk)
    s = torch.matmul(kq, keys.float()[:, None].transpose(-1, -2))
    pe = pe_q.to(dt).float().reshape(L, heads, dh)
    s = (s + torch.einsum("bthj,lhj->bhtl", kh, pe)) * dh ** -0.5
    if t_len is not None and t_len < T:
        keep = (torch.arange(T, device=keys.device) < t_len)[:, None]
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=2).to(dt).float()               # (B, h, T, L)
    vh = vv_tok.float().reshape(Bt, T, heads, dh).expand(B, T, heads, dh)
    attn = torch.einsum("bhtl,bthj->blhj", p, vh).reshape(B, L, D)
    return attn.to(dt)


def cross_i2t_tail_from_keys_plain(keys: torch.Tensor, wq: torch.Tensor,
                                   pe_q: torch.Tensor, kk_tok: torch.Tensor,
                                   vv_tok: torch.Tensor, wout: torch.Tensor,
                                   bout: torch.Tensor,
                                   ln_scale: torch.Tensor,
                                   ln_bias: torch.Tensor, heads: int,
                                   eps: float = 1e-5,
                                   t_len: Optional[int] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch version of kernel B4 (``_crossk_proj_ln_kernel``), in
    the reference's types: attn as :func:`cross_i2t_from_keys_plain`
    (rounded); y = attn Wout + bout rounded; LayerNorm(y + keys) in f32,
    output in keys' dtype."""
    dt = keys.dtype
    attn = cross_i2t_from_keys_plain(keys, wq, pe_q, kk_tok, vv_tok, heads,
                                     t_len).float()
    y = torch.matmul(attn, wout.to(dt).float()) + bout.float()
    x = y.to(dt).float() + keys.float()
    mean = x.mean(dim=-1, keepdim=True)
    cen = x - mean
    var = (cen * cen).mean(dim=-1, keepdim=True)
    out = cen * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    return out.to(dt)


def _check_i2t_shapes(name, keys, wq, pe_q, kk_tok, vv_tok, heads, t_len):
    """The shape checks of B4 and B7 on any device: returns (T, D, t_len)."""
    if keys.dim() != 3 or kk_tok.dim() != 3 or kk_tok.shape != vv_tok.shape:
        raise ValueError(f"{name}: keys (B, L, dk) and kk_tok == vv_tok (B, "
                         f"T, D) shapes expected")
    L, dk = keys.shape[1], keys.shape[2]
    T, D = kk_tok.shape[1], kk_tok.shape[2]
    tl = T if t_len is None else int(t_len)
    if (D % heads or wq.shape != (dk, D) or pe_q.numel() != L * D
            or not 1 <= tl <= T):
        raise ValueError(f"{name}: inconsistent shapes keys "
                         f"{tuple(keys.shape)}, tokens {tuple(kk_tok.shape)}, "
                         f"wq {tuple(wq.shape)}, heads {heads}, t_len {tl}")
    return T, D, tl


def _i2t_kernel_operands(name, keys, wq, pe_q, kk_tok, vv_tok, heads):
    """The card-side checks of B4 and B7 and the operands they share: (B,
    device, dtype, wq and pe_q in the dtype, the scratch in which the
    kernels form k_tok Wq^T once per prompt)."""
    dev, dt = _check_device_tensors(name, (keys, kk_tok, vv_tok))
    L, dk = keys.shape[1], keys.shape[2]
    T, D = kk_tok.shape[1], kk_tok.shape[2]
    if (T > CROSS_MAX_TOKENS or heads * T > CROSS_MAX_ROWS or dk % 16
            or dk > CROSS_MAX_DK or (D // heads) % 4):
        raise ValueError(f"{name} takes T <= {CROSS_MAX_TOKENS}, "
                         f"heads*T <= {CROSS_MAX_ROWS}, dk % 16 == 0, dk <= "
                         f"{CROSS_MAX_DK}, head size % 4 == 0; got T={T}, "
                         f"heads={heads}, dk={dk}, D={D}")
    B = max(keys.shape[0], kk_tok.shape[0])
    _check_cross_batches(name, B, keys, kk_tok, vv_tok)
    if _batch_stride(kk_tok) != _batch_stride(vv_tok):
        raise ValueError(f"{name}: kk_tok and vv_tok need one batch stride")
    wq = wq.to(dt).contiguous()
    pe = _aligned16(pe_q.to(dt).reshape(L, D).contiguous())
    if wq.device != dev or pe.device != dev:
        raise ValueError(f"{name}: weights must be on {dev}")
    kq = torch.empty((B if kk_tok.shape[0] > 1 else 1, heads * T, dk),
                     dtype=dt, device=dev)
    return B, dev, dt, wq, pe, kq


def cross_i2t_tail_from_keys(keys: torch.Tensor, wq: torch.Tensor,
                             pe_q: torch.Tensor, kk_tok: torch.Tensor,
                             vv_tok: torch.Tensor, wout: torch.Tensor,
                             bout: torch.Tensor, ln_scale: torch.Tensor,
                             ln_bias: torch.Tensor, heads: int,
                             eps: float = 1e-5,
                             t_len: Optional[int] = None) -> torch.Tensor:
    """Image -> token cross attention plus its image-side tail (B4): keys
    (B or 1, L, dk), wq (dk, D), pe_q (1, L, D) = image_pe Wq + bq, kk_tok /
    vv_tok (B or 1, T, D) projected tokens, wout (D, dk), bout / ln_scale /
    ln_bias (dk,) -> the next layer's keys (B, L, dk) in keys' dtype.
    Tokens at or past ``t_len`` (default T) are masked.

    CPU tensors run :func:`cross_i2t_tail_from_keys_plain`; CUDA tensors
    launch kernel B4 (``csrc/cross_i2t_tail.cu``) or raise."""
    T, D, tl = _check_i2t_shapes("cross_i2t_tail_from_keys", keys, wq, pe_q,
                                 kk_tok, vv_tok, heads, t_len)
    L, dk = keys.shape[1], keys.shape[2]
    if wout.shape != (D, dk) or any(t.shape != (dk,)
                                    for t in (bout, ln_scale, ln_bias)):
        raise ValueError(f"cross_i2t_tail_from_keys: wout {tuple(wout.shape)}"
                         f" must be ({D}, {dk}), bout / ln_scale / ln_bias "
                         f"({dk},)")
    if keys.device.type == "cpu":
        return cross_i2t_tail_from_keys_plain(
            keys, wq, pe_q, kk_tok, vv_tok, wout, bout, ln_scale, ln_bias,
            heads, eps=eps, t_len=t_len)
    B, dev, dt, wq, pe, kq = _i2t_kernel_operands(
        "cross_i2t_tail", keys, wq, pe_q, kk_tok, vv_tok, heads)
    if dt == torch.bfloat16 and D > I2T_MAX_D_BF16:
        raise ValueError(f"cross_i2t_tail takes D <= {I2T_MAX_D_BF16} "
                         f"in bf16, got {D}")
    if dt == torch.float32:
        keys = _aligned16(keys)  # the f32 kernel reads keys 16 bytes a load
    wout = wout.to(dt).contiguous()
    bo, g, bb = (t.float().contiguous() for t in (bout, ln_scale, ln_bias))
    for t in (wout, bo, g, bb):
        if t.device != dev:
            raise ValueError(f"cross_i2t_tail: weights must be on {dev}")
    out = torch.empty((B, L, dk), dtype=dt, device=dev)
    fn = cuda_build.library("cross_i2t_tail").ovo_cross_i2t_tail
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(keys.data_ptr(), wq.data_ptr(), pe.data_ptr(),
                 kk_tok.data_ptr(), vv_tok.data_ptr(), wout.data_ptr(),
                 bo.data_ptr(), g.data_ptr(), bb.data_ptr(), out.data_ptr(),
                 kq.data_ptr(),
                 B, T, heads, tl, L, dk, D, float((D // heads) ** -0.5),
                 float(eps), _batch_stride(keys), _batch_stride(kk_tok),
                 _DTYPES[dt], stream)
    cuda_build.check(err, "cross_i2t_tail")
    cuda_build.count_launch("cross_i2t_tail")
    return out


# ovo_cross_i2t_proj(keys, wq, peq, kt, vt, out, kq, B, NT, heads, t_len, L,
# dk, D, scale, k_sb, t_sb, dtype)
_I2T_PROJ = cuda_build.Entry(
    "cross_i2t_proj", "ovo_cross_i2t_proj",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int])


def cross_i2t_from_keys(keys: torch.Tensor, wq: torch.Tensor,
                        pe_q: torch.Tensor, kk_tok: torch.Tensor,
                        vv_tok: torch.Tensor, heads: int,
                        t_len: Optional[int] = None) -> torch.Tensor:
    """Image -> token cross attention reading the raw keys stream (B7):
    keys (B or 1, L, dk), wq (dk, D), pe_q (1, L, D) = image_pe Wq + bq,
    kk_tok / vv_tok (B or 1, T, D) projected tokens -> (B, L, D)
    pre-out-projection, in keys' dtype. Tokens at or past ``t_len``
    (default T) are masked.

    CPU tensors run :func:`cross_i2t_from_keys_plain`; CUDA tensors launch
    kernel B7 (``csrc/cross_i2t_proj.cu``) or raise."""
    T, D, tl = _check_i2t_shapes("cross_i2t_from_keys", keys, wq, pe_q,
                                 kk_tok, vv_tok, heads, t_len)
    if keys.device.type == "cpu":
        return cross_i2t_from_keys_plain(keys, wq, pe_q, kk_tok, vv_tok,
                                         heads, t_len=t_len)
    if D > CROSS_MAX_DK:
        raise ValueError(f"cross_i2t_proj takes D <= {CROSS_MAX_DK}, got {D}")
    B, dev, dt, wq, pe, kq = _i2t_kernel_operands(
        "cross_i2t_proj", keys, wq, pe_q, kk_tok, vv_tok, heads)
    if dt == torch.bfloat16 and D > I2T_MAX_D_BF16:
        raise ValueError(f"cross_i2t_proj takes D <= {I2T_MAX_D_BF16} in "
                         f"bf16, got {D}")
    if dt == torch.float32:
        keys = _aligned16(keys)  # the f32 kernel reads keys 16 bytes a load
    L, dk = keys.shape[1], keys.shape[2]
    out = torch.empty((B, L, D), dtype=dt, device=dev)
    err = _I2T_PROJ(dev.index, keys.data_ptr(), wq.data_ptr(), pe.data_ptr(),
                    kk_tok.data_ptr(), vv_tok.data_ptr(), out.data_ptr(),
                    kq.data_ptr(), B, T, heads, tl, L, dk, D,
                    float((D // heads) ** -0.5), _batch_stride(keys),
                    _batch_stride(kk_tok), _DTYPES[dt])
    cuda_build.check(err, "cross_i2t_proj")
    cuda_build.count_launch("cross_i2t_proj")
    return out


# ---------------------------------------------------------------------------
# B9a / B9b: the decoder's token <-> image attention on pre-projected
# operands (the unfused route)
# ---------------------------------------------------------------------------

SMALL_HEAD_DIM = 16
SHORT_SIDE = 64          # the token side: at most 64 rows


# ovo_cross_small_head_t2i(q, k, v, out, B, NT, heads, L, D, scale, q_sb,
# k_sb, v_sb, dtype); ovo_cross_small_head_i2t(q, k, v, out, B, NT, t_len,
# heads, L, D, scale, q_sb, t_sb, dtype)
_SMALL_HEAD_T2I = cuda_build.Entry(
    "cross_small_head", "ovo_cross_small_head_t2i",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_longlong] * 3 + [ctypes.c_int])
_SMALL_HEAD_I2T = cuda_build.Entry(
    "cross_small_head", "ovo_cross_small_head_i2t",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_longlong] * 2 + [ctypes.c_int])


def cross_attention_small_head_plain(qq: torch.Tensor, kk: torch.Tensor,
                                     vv: torch.Tensor, heads: int,
                                     t_len: Optional[int] = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version of kernels B9a / B9b: the reference's
    ``_xla_cross`` (split heads, :func:`xla_attention`, merge heads) with
    batch-1 operands broadcast; keys at or past ``t_len`` at -1e30."""
    B = max(qq.shape[0], kk.shape[0])
    D = qq.shape[-1]
    dh = D // heads

    def heads_of(t):
        h = t.reshape(t.shape[0], t.shape[1], heads, dh).transpose(1, 2)
        return h.expand((B,) + h.shape[1:])

    keep = _keys_below(kk.shape[1], t_len, qq.device)
    o = xla_attention(heads_of(qq), heads_of(kk), heads_of(vv), mask=keep)
    return o.transpose(1, 2).reshape(B, qq.shape[1], D)


def cross_attention_small_head(qq: torch.Tensor, kk: torch.Tensor,
                               vv: torch.Tensor, heads: int, *,
                               t_len: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention on pre-projected (B or 1, Lq, D) x (B or 1, Lk,
    D) operands with heads of 16 (the SAM decoder's cross attention), one
    side at most 64 rows: token -> image (t2i, Lq <= 64 < Lk) or image ->
    token (i2t, Lk <= 64 < Lq; tokens at or past ``t_len`` masked). Output
    (B, Lq, D) in qq's dtype; batch-1 operands are shared, never broadcast
    in memory.

    CPU tensors run :func:`cross_attention_small_head_plain`; CUDA tensors
    launch kernel B9a or B9b (``csrc/cross_small_head.cu``) or raise."""
    if qq.dim() != 3 or kk.dim() != 3 or kk.shape != vv.shape \
            or qq.shape[2] != kk.shape[2]:
        raise ValueError(f"cross_attention_small_head: (B, L, D) operands "
                         f"with kk.shape == vv.shape expected, got "
                         f"{tuple(qq.shape)}, {tuple(kk.shape)}, "
                         f"{tuple(vv.shape)}")
    Lq, Lk, D = qq.shape[1], kk.shape[1], qq.shape[2]
    t2i = Lq <= SHORT_SIDE < Lk
    i2t = Lk <= SHORT_SIDE < Lq
    if not (t2i or i2t):
        raise ValueError(f"cross_attention_small_head: one side must have at "
                         f"most {SHORT_SIDE} rows and the other more; got "
                         f"Lq={Lq}, Lk={Lk}")
    tl = Lk if t_len is None else int(t_len)
    if t_len is not None and (t2i or not 1 <= tl <= Lk):
        raise ValueError(f"cross_attention_small_head: t_len {t_len} masks "
                         f"tokens of i2t only, 1 <= t_len <= {Lk}")
    if qq.device.type == "cpu":
        return cross_attention_small_head_plain(qq, kk, vv, heads,
                                                t_len=t_len)
    name = "cross_small_head_t2i" if t2i else "cross_small_head_i2t"
    dev, dt = _check_device_tensors(name, (qq, kk, vv))
    if D % heads or D // heads != SMALL_HEAD_DIM or D > CROSS_MAX_DK:
        raise ValueError(f"{name} takes heads of {SMALL_HEAD_DIM}, D <= "
                         f"{CROSS_MAX_DK}; got D={D}, heads={heads}")
    B = max(qq.shape[0], kk.shape[0])
    _check_cross_batches(name, B, qq, kk, vv)
    if i2t and _batch_stride(kk) != _batch_stride(vv):
        raise ValueError(f"{name}: kk and vv need one batch stride")
    for t in (qq, kk, vv):
        if t.data_ptr() % 16 or _batch_stride(t) % 4:
            raise ValueError(f"{name}: operands must be 16-byte aligned with "
                             f"batch strides a multiple of 4")
    out = torch.empty((B, Lq, D), dtype=dt, device=dev)
    scale = float(SMALL_HEAD_DIM ** -0.5)
    if t2i:
        err = _SMALL_HEAD_T2I(
            dev.index, qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
            out.data_ptr(), B, Lq, heads, Lk, D, scale, _batch_stride(qq),
            _batch_stride(kk), _batch_stride(vv), _DTYPES[dt])
    else:
        err = _SMALL_HEAD_I2T(
            dev.index, qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
            out.data_ptr(), B, Lk, tl, heads, Lq, D, scale, _batch_stride(qq),
            _batch_stride(kk), _DTYPES[dt])
    cuda_build.check(err, name)
    cuda_build.count_launch(name)
    return out

