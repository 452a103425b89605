"""Whole pre-LN transformer blocks in two kernels each: B12a and B12b.

Port of ``ovo_tpu/ops/fused_block.py``, the opt-in tower path
(``OVO_FUSED_BLOCK=1`` or ``attn_impl="fused_block"``):

  - ``fused_attn_block`` (B12a, ``fused_block.py:106``): LN1 -> per-head
    qkv -> RoPE-2D -> attention -> out-projection summed over heads ->
    residual;
  - ``fused_mlp_block`` (B12b, ``:184``): LN2 -> fc -> gelu -> proj summed
    over hidden chunks -> residual;
  - ``fused_transformer_block`` (``:277``): one block through both, with
    the per-head weight arrangement (``_arrange_attn_weights``, ``:243``)
    cached on the block module.

On a CUDA tensor each wrapper launches its kernel (``csrc/fused_attn_block.cu``,
``csrc/fused_mlp_block.cu``) or raises; in bf16 the kernel runs its GEMMs on
the tensor cores where the shape allows, and B12a's attention on B5's
two-pass tensor-core kernel (:func:`attn_block_routes` /
:func:`mlp_block_routes` report what the kernel chose). On a CPU tensor it
runs its ``*_plain`` version, which follows the TPU kernels' op order: f32 LayerNorm
statistics with LN(x) rounded to x's dtype; per head qkv in f32 plus the f32
bias, RoPE in f32 on the f32 q and k, q / k / v rounded to the dtype, f32
scores scaled after the dot, keys at or past ``L_real`` (and later keys when
causal) at -1e30, an f32 softmax rounded to the dtype, p.v rounded to the
dtype, and the out-projection summed over heads in head order in f32; the
MLP sums its proj over hidden chunks of ``chunk`` in chunk order. The output
is ``(x + acc + bias)`` in f32, rounded once.

The TPU kernels work on one token-padded (Lp, D) slab per call (the tower
pads to a multiple of 128 and vmaps over views); these take the (B, L, D)
batch of views in one call and need no pad: keys at or past ``L_real`` get
exactly zero weight either way.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"gelu": 0, "quick_gelu": 1}
_NEG = -1e30
MAX_TOKENS = 1024
# the qkv route bit of ovo_fused_attn_block_routes
_QKV_ROPE = 1


# the route queries (host side, no stream) and the two launches
_MLP_ROUTES = cuda_build.Entry(
    "fused_mlp_block", "ovo_fused_mlp_block_routes",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4, stream=False)
_ATTN_ROUTES = cuda_build.Entry(
    "fused_attn_block", "ovo_fused_attn_block_routes",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4, stream=False)
_MLP_BLOCK = cuda_build.Entry(
    "fused_mlp_block", "ovo_fused_mlp_block",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6)
_ATTN_BLOCK = cuda_build.Entry(
    "fused_attn_block", "ovo_fused_attn_block",
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8)


def mlp_block_routes(x: torch.Tensor, fc_w: torch.Tensor,
                     proj_w: torch.Tensor, chunk: int) -> dict:
    """What runs B12b's two GEMMs on the card for these CUDA tensors, as
    the kernel chooses (``csrc/fused_mlp_block.cu`` ``mlp_routes``):
    ``"mma"`` (bf16 tensor cores: N a multiple of the tile's N extent, K
    and the chunk multiples of its k step, aligned weights) or ``"fma"``
    (f32 FMAs on the CUDA cores: float32 and the other widths)."""
    D, hidden = fc_w.shape
    bits = _MLP_ROUTES.fn(
        x.data_ptr(), fc_w.data_ptr(), proj_w.data_ptr(), D, hidden,
        min(chunk, hidden), _DTYPES[x.dtype])
    return dict(fc="mma" if bits & 1 else "fma",
                proj="mma" if bits & 2 else "fma")


def attn_block_routes(x: torch.Tensor, w_heads: torch.Tensor,
                      ow_heads: torch.Tensor, *, n_heads: int,
                      causal: bool) -> dict:
    """What runs B12a's stages on the card for these CUDA tensors, as the
    kernel chooses (``csrc/fused_attn_block.cu`` ``attn_routes``). ``qkv``:
    ``"mma_rope"`` (bf16 tensor cores, bias and RoPE in the epilogue,
    written packed: hd 64, the PE tower's) or ``"fma"`` (f32 FMAs into an
    f32 scratch, then a RoPE and packing launch); ``attention``: ``"mma"``
    (B5's two-pass tensor-core kernel: bf16, not causal, hd a multiple of
    16) or ``"fma"``; ``out``: ``"mma"`` or ``"fma"``, as for B12b."""
    D = w_heads.shape[1]
    bits = _ATTN_ROUTES.fn(
        x.data_ptr(), w_heads.data_ptr(), ow_heads.data_ptr(), D, n_heads,
        int(causal), _DTYPES[x.dtype])
    return dict(qkv="mma_rope" if bits & _QKV_ROPE else "fma",
                attention="mma" if bits & 2 else "fma",
                out="mma" if bits & 4 else "fma")


def _ln_rows(x: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    ln = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (ln * scale.float() + bias.float()).to(x.dtype)


def _rot(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = t.shape[-1] // 2
    t1, t2 = t[..., :half], t[..., half:]
    return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# B12a: attention half
# ---------------------------------------------------------------------------

def fused_attn_block_plain(x: torch.Tensor, w_heads: torch.Tensor,
                           b_heads: torch.Tensor, ow_heads: torch.Tensor,
                           out_b: torch.Tensor, ln_scale: torch.Tensor,
                           ln_bias: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor, *, n_heads: int, L_real: int,
                           causal: bool, use_rope: bool) -> torch.Tensor:
    """Plain PyTorch version of kernel B12a (``_attn_kernel``) in its op
    order; x (B, L, D), w_heads (heads, D, 3hd), b_heads (heads, 3hd) f32,
    ow_heads (heads, hd, D), out_b (D,) f32, cos / sin (L, hd/2) f32."""
    dt = x.dtype
    L = x.shape[-2]
    hd = w_heads.shape[-1] // 3
    lnx = _ln_rows(x, ln_scale, ln_bias).float()
    col = torch.arange(L, device=x.device)
    mask = (col >= L_real)[None, :]
    if causal:
        mask = mask | (col[None, :] > col[:, None])
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for h in range(n_heads):
        qkv = lnx @ w_heads[h].float() + b_heads[h].float()
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        if use_rope:
            q, k = _rot(q, cos, sin), _rot(k, cos, sin)
        s = (q.to(dt).float() @ k.to(dt).float().transpose(-1, -2)) \
            * hd ** -0.5
        s = torch.where(mask, torch.full_like(s, _NEG), s)
        p = torch.softmax(s, dim=-1).to(dt)
        oh = (p.float() @ v.to(dt).float()).to(dt)
        acc = acc + oh.float() @ ow_heads[h].float()
    return (x.float() + acc + out_b.float()).to(dt)


def _check_cuda(name, x, weights, f32s):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    for t in weights:
        if t.device != dev or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous {x.dtype} "
                             f"on {dev}; got {t.dtype} on {t.device}")
    for t in f32s:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: biases, LayerNorm and RoPE tables "
                             f"must be contiguous f32 on {dev}; got "
                             f"{t.dtype} on {t.device}")


def fused_attn_block(x: torch.Tensor, w_heads: torch.Tensor,
                     b_heads: torch.Tensor, ow_heads: torch.Tensor,
                     out_b: torch.Tensor, ln_scale: torch.Tensor,
                     ln_bias: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, *, n_heads: int, L_real: int,
                     causal: bool, use_rope: bool) -> torch.Tensor:
    """x (B, L, D) -> x + attn(LN(x)) (B12a). Weight layout: w_heads
    (heads, D, 3hd) as [q | k | v] per head, b_heads (heads, 3hd) f32,
    ow_heads (heads, hd, D), out_b (D,) f32; cos / sin (L, hd/2) f32 (read
    only with ``use_rope``). Keys at or past ``L_real`` are masked.

    CPU tensors run :func:`fused_attn_block_plain`; CUDA tensors launch
    kernel B12a (``csrc/fused_attn_block.cu``) or raise."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    B, L, D = x.shape
    if D % n_heads or w_heads.shape != (n_heads, D, 3 * (D // n_heads)) \
            or ow_heads.shape != (n_heads, D // n_heads, D) \
            or b_heads.shape != (n_heads, 3 * (D // n_heads)):
        raise ValueError(f"weights {tuple(w_heads.shape)}, "
                         f"{tuple(b_heads.shape)}, {tuple(ow_heads.shape)} "
                         f"do not match D={D}, heads={n_heads}")
    hd = D // n_heads
    if not 1 <= L_real <= L:
        raise ValueError(f"L_real {L_real} outside [1, {L}]")
    if use_rope and (cos.shape != (L, hd // 2) or sin.shape != cos.shape):
        raise ValueError(f"RoPE tables {tuple(cos.shape)} != {(L, hd // 2)}")
    if x.device.type == "cpu":
        return fused_attn_block_plain(
            x, w_heads, b_heads, ow_heads, out_b, ln_scale, ln_bias, cos,
            sin, n_heads=n_heads, L_real=L_real, causal=causal,
            use_rope=use_rope)
    _check_cuda("fused_attn_block", x, (w_heads, ow_heads),
                (b_heads, out_b, ln_scale, ln_bias, cos, sin))
    if L > MAX_TOKENS or hd % 8 or hd > 128 or not x.is_contiguous():
        raise ValueError(f"fused_attn_block: kernel takes contiguous x with "
                         f"L <= {MAX_TOKENS} and hd % 8 == 0, hd <= 128; got "
                         f"L={L}, hd={hd}")
    dev, dt = x.device, x.dtype
    M = B * L
    out = torch.empty_like(x)
    # scratch: lnx (M, D), the packed [q | k | v] (M, 3D) and the heads
    # (M, D) in one allocation; the f32 q, k, v before RoPE apart, where
    # the qkv GEMM does not take the tensor cores
    work = torch.empty(5 * M * D, dtype=dt, device=dev)
    lnx, packed, oh = (work.data_ptr() + i * M * D * work.element_size()
                       for i in (0, 1, 4))
    qkv32 = None
    if attn_block_routes(x, w_heads, ow_heads, n_heads=n_heads,
                         causal=causal)["qkv"] == "fma":
        qkv32 = torch.empty((M, 3 * D), dtype=torch.float32, device=dev)
    err = _ATTN_BLOCK(
        dev.index, x.data_ptr(), w_heads.data_ptr(), b_heads.data_ptr(),
        ow_heads.data_ptr(), out_b.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
        lnx, None if qkv32 is None else qkv32.data_ptr(), packed, oh, B, L,
        D, n_heads, int(L_real), int(causal), int(use_rope), _DTYPES[dt])
    cuda_build.check(err, "fused_attn_block")
    cuda_build.count_launch("fused_attn_block")
    return out


# ---------------------------------------------------------------------------
# B12b: MLP half
# ---------------------------------------------------------------------------

def _act(h: torch.Tensor, act: str, dt: torch.dtype) -> torch.Tensor:
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if dt == torch.bfloat16:   # layers.gelu's dtype rule
        return F.gelu(h, approximate="tanh")
    return F.gelu(h)


def _check_chunk(hidden: int, chunk: int) -> int:
    chunk = min(chunk, hidden)
    if hidden % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide mlp hidden dim {hidden}")
    return chunk


def fused_mlp_block_plain(x: torch.Tensor, fc_w: torch.Tensor,
                          fc_b: torch.Tensor, proj_w: torch.Tensor,
                          proj_b: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, *, act: str = "gelu",
                          chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of kernel B12b (``_mlp_kernel``) in its op
    order: per hidden chunk, f32 fc plus the f32 bias, the activation in
    f32, rounded to the dtype, and the proj accumulated in f32."""
    dt = x.dtype
    hidden = fc_w.shape[1]
    chunk = _check_chunk(hidden, chunk)
    lnx = _ln_rows(x, ln_scale, ln_bias).float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for c0 in range(0, hidden, chunk):
        h = lnx @ fc_w[:, c0:c0 + chunk].float() + fc_b[c0:c0 + chunk].float()
        h = _act(h, act, dt).to(dt)
        acc = acc + h.float() @ proj_w[c0:c0 + chunk].float()
    return (x.float() + acc + proj_b.float()).to(dt)


def fused_mlp_block(x: torch.Tensor, fc_w: torch.Tensor, fc_b: torch.Tensor,
                    proj_w: torch.Tensor, proj_b: torch.Tensor,
                    ln_scale: torch.Tensor, ln_bias: torch.Tensor, *,
                    act: str = "gelu", chunk: int = 1024) -> torch.Tensor:
    """x (B, L, D) -> x + mlp(LN(x)) (B12b); fc_w (D, hidden), proj_w
    (hidden, D) in x's dtype, biases f32; the proj sums over hidden chunks
    of ``min(chunk, hidden)``, which must divide hidden (as in JAX).

    CPU tensors run :func:`fused_mlp_block_plain`; CUDA tensors launch
    kernel B12b (``csrc/fused_mlp_block.cu``) or raise."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    B, L, D = x.shape
    hidden = fc_w.shape[1]
    if fc_w.shape != (D, hidden) or proj_w.shape != (hidden, D):
        raise ValueError(f"fc {tuple(fc_w.shape)} / proj "
                         f"{tuple(proj_w.shape)} do not match D={D}")
    chunk = _check_chunk(hidden, chunk)
    if x.device.type == "cpu":
        return fused_mlp_block_plain(x, fc_w, fc_b, proj_w, proj_b,
                                     ln_scale, ln_bias, act=act, chunk=chunk)
    _check_cuda("fused_mlp_block", x, (fc_w, proj_w),
                (fc_b, proj_b, ln_scale, ln_bias))
    if chunk % 8 or not x.is_contiguous():
        raise ValueError(f"fused_mlp_block: kernel takes contiguous x and "
                         f"chunk % 8 == 0; got chunk {chunk}")
    dev, dt = x.device, x.dtype
    M = B * L
    out = torch.empty_like(x)
    # scratch: lnx (M, D) and h (M, hidden) in one allocation
    work = torch.empty(M * (D + hidden), dtype=dt, device=dev)
    lnx, h = work.data_ptr(), work.data_ptr() + M * D * work.element_size()
    err = _MLP_BLOCK(
        dev.index, x.data_ptr(), fc_w.data_ptr(), fc_b.data_ptr(),
        proj_w.data_ptr(), proj_b.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), out.data_ptr(), lnx, h, M, D, hidden, chunk,
        _ACTS[act], _DTYPES[dt])
    cuda_build.check(err, "fused_mlp_block")
    cuda_build.count_launch("fused_mlp_block")
    return out


# ---------------------------------------------------------------------------
# block-level wrapper
# ---------------------------------------------------------------------------

def _arrange_attn_weights(blk, n_heads: int):
    """qkv (D, 3D) + out (D, D) -> per-head w_heads (heads, D, 3hd),
    b_heads (heads, 3hd) f32, ow_heads (heads, hd, D) and the out bias f32
    (zeros where the block has no bias)."""
    qkv_w, out_w = blk.attn.qkv.w, blk.attn.out.w
    D = out_w.shape[0]
    hd = D // n_heads
    w_heads = qkv_w.reshape(D, 3, n_heads, hd).permute(2, 0, 1, 3).reshape(
        n_heads, D, 3 * hd).contiguous()
    qkv_b = blk.attn.qkv.b
    if qkv_b is None:
        qkv_b = qkv_w.new_zeros((3 * D,))
    b_heads = qkv_b.float().reshape(3, n_heads, hd).permute(1, 0, 2).reshape(
        n_heads, 3 * hd).contiguous()
    ow_heads = out_w.reshape(n_heads, hd, D)
    ob = blk.attn.out.b
    ob = out_w.new_zeros((D,)) if ob is None else ob
    return w_heads, b_heads, ow_heads, ob.float().contiguous()


def _arranged(blk, n_heads: int):
    """The block's arranged attention weights, cached on the module and
    rebuilt when a weight tensor is replaced or written in place."""
    tensors = (blk.attn.qkv.w, blk.attn.qkv.b, blk.attn.out.w, blk.attn.out.b)
    key = (n_heads,) + tuple(None if t is None else (t.data_ptr(), t._version)
                             for t in tensors)
    cached = getattr(blk, "_fused_arranged", None)
    if cached is None or cached[0] != key:
        cached = (key, _arrange_attn_weights(blk, n_heads))
        blk._fused_arranged = cached
    return cached[1]


def fused_transformer_block(blk, x: torch.Tensor, n_heads: int,
                            rope: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                            causal: bool = False, act: str = "gelu",
                            l_real: Optional[int] = None) -> torch.Tensor:
    """One pre-LN block (``layers.transformer_block`` semantics, no
    LayerScale) through B12a and B12b on x (B, L, D); ``rope`` tables cover
    the L rows and ``l_real`` masks keys at or past it."""
    if getattr(blk, "ls1", None) is not None:
        raise ValueError("fused blocks do not carry LayerScale")
    w_heads, b_heads, ow_heads, ob = _arranged(blk, n_heads)
    B, L, D = x.shape
    hd = D // n_heads
    if rope is not None:
        cos, sin = (t[:L].float().contiguous() for t in rope)
    else:
        cos = sin = torch.zeros((L, hd // 2), dtype=torch.float32,
                                device=x.device)
    dt = x.dtype
    h = fused_attn_block(
        x, w_heads.to(dt), b_heads, ow_heads.to(dt), ob,
        blk.ln1.scale, blk.ln1.bias, cos, sin, n_heads=n_heads,
        L_real=l_real if l_real is not None else L, causal=causal,
        use_rope=rope is not None)
    mlp = blk.mlp
    hidden = mlp.fc.w.shape[1]

    def f32(b, n):
        return torch.zeros((n,), dtype=torch.float32, device=x.device) \
            if b is None else b.float().contiguous()

    return fused_mlp_block(h, mlp.fc.w.to(dt), f32(mlp.fc.b, hidden),
                           mlp.proj.w.to(dt), f32(mlp.proj.b, D),
                           blk.ln2.scale, blk.ln2.bias, act=act,
                           chunk=min(512, hidden))
