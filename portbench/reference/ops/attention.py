"""Plain attention: the functions the port's attention kernels compute,
frozen from the port's ``ops/attention.py`` plain versions. Every
kernel name runs its plain version on any device."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


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


CROSS_MAX_ROWS = 64      # heads * tokens


CROSS_MAX_TOKENS = 16    # B4's tokens per head


CROSS_MAX_DK = 256


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


SMALL_HEAD_DIM = 16


SHORT_SIDE = 64          # the token side: at most 64 rows


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


# kernel calls are noted while ``recording()`` is on: the benchmark reads
# each call's family and shapes to bound the port's kernels
_CALLS = None


@contextlib.contextmanager
def recording():
    """Collect ``(family, shapes)`` of every kernel-named call inside."""
    global _CALLS
    _CALLS = []
    try:
        yield _CALLS
    finally:
        _CALLS = None


def note(family, **kw):
    if _CALLS is not None:
        _CALLS.append((family, kw))


_ROUTE_FAMILY = {"fused": "fused_attention", "windowed": "windowed_attention",
                 "flash": "flash_attention"}


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          causal: bool = False) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D) softmax attention,
    noted under the kernel the port's route picks."""
    route = attention_route(q.shape[-2], k.shape[-2], q.shape[-1],
                            causal=causal, has_mask=mask is not None)
    if route != "xla":
        note(_ROUTE_FAMILY[route], q=tuple(q.shape), k=tuple(k.shape),
             dtype=q.dtype)
    if causal and mask is None:
        lq, lk = q.shape[-2], k.shape[-2]
        mask = torch.ones((lq, lk), dtype=torch.bool,
                          device=q.device).tril()[None, None]
    return xla_attention(q, k, v, mask=mask, scale=scale)


def rope_packed_attention(qkv, cos, sin, *, heads, scale=None, kv_len=None):
    note("rope_packed_attention", qkv=tuple(qkv.shape), heads=heads,
         kv_len=kv_len or qkv.shape[1], dtype=qkv.dtype)
    return rope_packed_attention_plain(qkv, cos, sin, heads=heads,
                                       scale=scale, kv_len=kv_len)


def packed_heads_attention(q, k, v, *, heads, scale=None):
    note("packed_heads_attention", q=tuple(q.shape), k=tuple(k.shape),
         heads=heads, dtype=q.dtype)
    return packed_heads_attention_plain(q, k, v, heads=heads, scale=scale)


def cross_attention_small_head(qq, kk, vv, heads, *, t_len=None):
    note("cross_small_head", q=tuple(qq.shape), k=tuple(kk.shape),
         heads=heads, dtype=qq.dtype)
    return cross_attention_small_head_plain(qq, kk, vv, heads, t_len=t_len)


def cross_t2i_from_keys(q_proj, keys, wk, wv, pe_k, bv, heads):
    note("cross_t2i", q=tuple(q_proj.shape), keys=tuple(keys.shape),
         heads=heads, dtype=keys.dtype)
    return cross_t2i_from_keys_plain(q_proj, keys, wk, wv, pe_k, bv, heads)


def cross_i2t_from_keys(keys, wq, pe_q, kk_tok, vv_tok, heads, t_len=None):
    note("cross_i2t_proj", keys=tuple(keys.shape), tok=tuple(kk_tok.shape),
         heads=heads, dtype=keys.dtype)
    return cross_i2t_from_keys_plain(keys, wq, pe_q, kk_tok, vv_tok, heads,
                                     t_len)


def cross_i2t_tail_from_keys(keys, wq, pe_q, kk_tok, vv_tok, wout, bout,
                             ln_scale, ln_bias, heads, eps=1e-5, t_len=None):
    note("cross_i2t_tail", keys=tuple(keys.shape), tok=tuple(kk_tok.shape),
         heads=heads, dtype=keys.dtype)
    return cross_i2t_tail_from_keys_plain(keys, wq, pe_q, kk_tok, vv_tok,
                                          wout, bout, ln_scale, ln_bias,
                                          heads, eps, t_len)


def flash_attention(q, k, v, *, scale=None, kv_len=None):
    note("flash_attention", q=tuple(q.shape), k=tuple(k.shape), dtype=q.dtype)
    return flash_attention_plain(q, k, v, scale=scale, kv_len=kv_len)


def windowed_fused_attention(q, k, v, *, scale=None, kv_len=None):
    note("windowed_attention", q=tuple(q.shape), k=tuple(k.shape),
         dtype=q.dtype)
    return windowed_attention_plain(q, k, v, scale=scale, kv_len=kv_len)


def fused_attention(q, k, v, *, scale=None, kv_len=None):
    note("fused_attention", q=tuple(q.shape), k=tuple(k.shape), dtype=q.dtype)
    return windowed_attention_plain(q, k, v, scale=scale, kv_len=kv_len)
