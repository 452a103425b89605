"""The share statistic that chip_smoke.py and the card tests hold kernels
B1 (flash_attention), B2 (windowed_fused_attention), B11
(packed_heads_attention), B3 (cross_t2i), B4 (cross_i2t_tail), B7
(cross_i2t_proj), B5 (rope_packed_attention), B6 (masked_pool), B9a
(cross_small_head t2i), B9b (cross_small_head i2t) and B10
(fused_attention) to in bf16, beside
their max-abs limits: the share of outputs that differ from the plain
version by more than one bf16 step at the plain output's magnitude, at
most ``ATTN_SHARE`` (``B3_SHARE`` for B3, whose output dilutes a weight's
rounding over dk products).

On the CPU, at the main paths' head sizes and key counts: a reordered f32
sum of the right function (keys, or B4's and B7's tokens, permuted), B1's
p_hi + p_lo split of its f32 weights (the kernel's p . v) and B7's mma
chains, and B9b's mma steps, stay under the limit;
the functions the kernels must not compute break it. Those are B1 with its
weights rounded once to bf16 (which the max-abs limit alone passes), B2 /
B11 with exp(s - m) rounded before it is normalized, B3, B5 and B7 with
their normalized weights left unrounded, B4 with attn left unrounded, B6
with its f32 weights rounded once (the reference's XLA route), and B9a and
B9b with their normalized weights left unrounded.

B10 in f32 runs as 3xTF32 on the tensor cores: its limit
``chip_smoke.B10_F32_TOL`` passes an emulated 3xTF32 product and refuses
one TF32 product per f32 product, which the 1e-4 limit of the other f32
kernels would not.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from ovo_tpu_torch.ops import attention as A
from ovo_tpu_torch.ops import masked_pool as M_

BF = torch.bfloat16


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(BF)


def _permuted(t, perm):
    return t[..., perm, :]


def _flash_hi_lo(q, k, v):
    """B1's arithmetic on the tensor cores: f32 weights split into p_hi =
    bf16(p) and p_lo = bf16(p - p_hi), p . v = p_hi . v + p_lo . v."""
    s = torch.matmul(q.float() * q.shape[-1] ** -0.5,
                     k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    hi = p.to(BF).float()
    lo = (p - hi).to(BF).float()
    return (torch.matmul(hi, v.float()) + torch.matmul(lo, v.float())).to(BF)


@pytest.mark.parametrize("heads,L,hd", [(2, 1024, 72), (2, 300, 40)])
def test_flash_share_tells_rounded_weights_apart(heads, L, hd):
    rng = np.random.default_rng(L + hd)
    q, k, v = (_bf16(rng, 1, heads, L, hd) for _ in range(3))
    ref = A.flash_attention_plain(q, k, v)
    perm = torch.from_numpy(rng.permutation(L))
    reordered = A.flash_attention_plain(q, _permuted(k, perm),
                                        _permuted(v, perm))
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.ATTN_SHARE
    assert share(_flash_hi_lo(q, k, v), ref) <= chip_smoke.ATTN_SHARE
    once = chip_smoke.flash_attention_rounded_once(q, k, v)
    # the max-abs limit alone passes the once-rounded weights
    assert float((once.float() - ref.float()).abs().max()) <= 1e-2
    assert share(once, ref) > chip_smoke.ATTN_SHARE


@pytest.mark.parametrize("which", sorted(chip_smoke.B2_SHAPES))
def test_windowed_share_tells_early_rounding_apart(which):
    n, heads, lq, lk, hd = chip_smoke.B2_SHAPES[which]
    n = max(1, n // 8)
    rng = np.random.default_rng(lq + hd)
    q = _bf16(rng, n, heads, lq, hd)
    k, v = (_bf16(rng, n, heads, lk, hd) for _ in range(2))
    ref = A.windowed_attention_plain(q, k, v)
    perm = torch.from_numpy(rng.permutation(lk))
    reordered = A.windowed_attention_plain(q, _permuted(k, perm),
                                           _permuted(v, perm))
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.ATTN_SHARE
    early = chip_smoke.windowed_attention_rounded_early(q, k, v)
    assert share(early, ref) > chip_smoke.ATTN_SHARE


def test_packed_heads_share_tells_early_rounding_apart():
    """B11's check in chip_smoke.py: the wrong function on the head views,
    merged back to the packed layout."""
    n, L, heads, hd = 4, 196, 8, 72
    rng = np.random.default_rng(11)
    qkv = _bf16(rng, n, L, 3, heads * hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    ref = A.packed_heads_attention_plain(q, k, v, heads=heads)
    perm = torch.from_numpy(rng.permutation(L))
    reordered = A.packed_heads_attention_plain(q, k[:, perm], v[:, perm],
                                               heads=heads)
    qh, kh, vh = (t.reshape(n, L, heads, hd).transpose(1, 2)
                  for t in (q, k, v))
    early = chip_smoke.windowed_attention_rounded_early(qh, kh, vh).transpose(
        1, 2).reshape(n, L, heads * hd)
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.ATTN_SHARE
    assert share(early, ref) > chip_smoke.ATTN_SHARE


def test_step_share_counts_steps_at_each_magnitude():
    """One step at 1.0 is 2^-7, at 2^-10 it is 2^-17; a value one step off
    is not counted, two steps off is."""
    ref = torch.tensor([1.0, 2.0 ** -10, 0.0, -3.0])
    got = ref + torch.tensor([2.0 ** -7, 2 * 2.0 ** -17, 0.0, -2.0 ** -6])
    assert chip_smoke.step_share(got, ref) == 0.25


def _f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("B,Bk", [(8, 8), (16, 1)])
def test_cross_t2i_share_tells_unrounded_weights_apart(B, Bk):
    """B3 at the AMG's widths (8 heads x 8 tokens, D 128, dk 256) over 1024
    keys, per-prompt and shared keys."""
    heads, T, L, D, dk = 8, 8, 1024, 128, 256
    rng = np.random.default_rng(30 + Bk)
    q, keys = _bf16(rng, B, T, D), _bf16(rng, Bk, L, dk)
    wk = (_f32(rng, dk, D) * dk ** -0.5).to(BF)
    wv = (_f32(rng, dk, D) * dk ** -0.5).to(BF)
    pe, bv = _bf16(rng, 1, L, D), _f32(rng, D)
    args = (q, keys, wk, wv, pe, bv, heads)
    ref = A.cross_t2i_from_keys_plain(*args)
    perm = torch.from_numpy(rng.permutation(L))
    reordered = A.cross_t2i_from_keys_plain(q, keys[:, perm], wk, wv,
                                            pe[:, perm], bv, heads)
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.B3_SHARE
    wrong = chip_smoke.cross_t2i_unrounded_weights(*args)
    # B3's max-abs limit (3e-2) alone passes the unrounded weights
    assert float((wrong.float() - ref.float()).abs().max()) <= 3e-2
    assert share(wrong, ref) > chip_smoke.B3_SHARE


@pytest.mark.parametrize("B,Bk", [(4, 4), (8, 1)])
def test_cross_i2t_tail_share_tells_unrounded_attn_apart(B, Bk):
    """B4 at the AMG's widths over 512 image rows: tokens permuted (with
    their k and v rows) reorder the per-head softmax and p . v sums."""
    heads, T, L, D, dk = 8, 8, 512, 128, 256
    rng = np.random.default_rng(40 + Bk)
    keys = _bf16(rng, Bk, L, dk)
    wq = (_f32(rng, dk, D) * dk ** -0.5).to(BF)
    pe, kt, vt = _bf16(rng, 1, L, D), _bf16(rng, B, T, D), _bf16(rng, B, T, D)
    wout = (_f32(rng, D, dk) * D ** -0.5).to(BF)
    bout, g, b = _f32(rng, dk), _f32(rng, dk) * 0.1 + 1.0, _f32(rng, dk)
    args = (keys, wq, pe, kt, vt, wout, bout, g, b, heads)
    ref = A.cross_i2t_tail_from_keys_plain(*args)
    perm = torch.from_numpy(rng.permutation(T))
    reordered = A.cross_i2t_tail_from_keys_plain(
        keys, wq, pe, kt[:, perm], vt[:, perm], wout, bout, g, b, heads)
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.ATTN_SHARE
    wrong = chip_smoke.cross_i2t_tail_unrounded_attn(*args)
    assert share(wrong, ref) > chip_smoke.ATTN_SHARE


def _toward_zero(t):
    """f64 t rounded to f32 toward zero."""
    r = t.float()
    return torch.where(r.double().abs() > t.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _cross_i2t_mma(keys, wq, pe_q, kk_tok, vv_tok, heads, truncate):
    """B7's bf16 arithmetic as its tensor-core kernel does it: s summed as
    the mma chain sums it, dk in steps of 16 products, then the head's 16
    pe_q columns (one more mma), each step's exact sum rounded to f32 to
    nearest or (``truncate``) toward zero, the way the mma accumulates;
    p normalized, then rounded; p . v_tok one mma a head (8 tokens)."""
    L, dk = keys.shape[1], keys.shape[2]
    Bt, T, D = kk_tok.shape
    B = max(keys.shape[0], Bt)
    dh = D // heads
    to_f32 = _toward_zero if truncate else (lambda t: t.float())
    kh = kk_tok.float().reshape(Bt, T, heads, dh)
    kq = torch.einsum("bthj,chj->bhtc", kh,
                      wq.float().reshape(dk, heads, dh)).to(BF).float()
    kf = keys.float()[:, None]
    s = None
    for k0 in range(0, dk, 16):
        blk = (kq[..., k0:k0 + 16].double()
               @ kf[..., k0:k0 + 16].transpose(-1, -2).double())
        s = to_f32(blk if s is None else s.double() + blk)
    pe = pe_q.float().reshape(L, heads, dh)
    s = to_f32(s.double() + torch.einsum("bthj,lhj->bhtl", kh.double(),
                                         pe.double())) * dh ** -0.5
    p = torch.softmax(s, dim=2).to(BF).float()
    vh = vv_tok.float().reshape(Bt, T, heads, dh).expand(B, T, heads, dh)
    attn = to_f32(torch.einsum("bhtl,bthj->blhj", p.double(), vh.double()))
    return attn.reshape(B, L, D).to(BF)


@pytest.mark.parametrize("B,Bk", [(4, 4), (8, 1)])
def test_cross_i2t_proj_share_tells_unrounded_weights_apart(B, Bk):
    """B7 at the decoder's widths (8 heads x 8 tokens, D 128, dk 256) over
    512 image rows, per-prompt and shared keys: tokens permuted (with their
    k and v rows) and the tensor-core kernel's mma chains over the whole of
    dk (summed from zero once, to nearest or toward zero; 4.9e-5 at most in
    a CPU run) stay under ATTN_SHARE; the normalized weights left in f32
    (0.079-0.082) break it, which the max-abs limit (3e-2) alone passes."""
    heads, T, L, D, dk = 8, 8, 512, 128, 256
    rng = np.random.default_rng(80 + Bk)
    keys = _bf16(rng, Bk, L, dk)
    wq = (_f32(rng, dk, D) * dk ** -0.5).to(BF)
    pe, kt, vt = _bf16(rng, 1, L, D), _bf16(rng, B, T, D), _bf16(rng, B, T, D)
    args = (keys, wq, pe, kt, vt, heads)
    ref = A.cross_i2t_from_keys_plain(*args)
    perm = torch.from_numpy(rng.permutation(T))
    reordered = A.cross_i2t_from_keys_plain(keys, wq, pe, kt[:, perm],
                                            vt[:, perm], heads)
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.ATTN_SHARE
    for truncate in (False, True):
        mma = _cross_i2t_mma(*args, truncate=truncate)
        assert float((mma.float() - ref.float()).abs().max()) <= 3e-2
        assert share(mma, ref) <= chip_smoke.ATTN_SHARE / 20
    wrong = chip_smoke.cross_i2t_from_keys_unrounded_p(*args)
    assert float((wrong.float() - ref.float()).abs().max()) <= 3e-2
    assert share(wrong, ref) > chip_smoke.ATTN_SHARE


@pytest.mark.parametrize("B,heads,L,kv_len", [(2, 4, 584, 577),
                                              (2, 16, 300, 290)])
def test_rope_packed_share_tells_unrounded_weights_apart(B, heads, L, kv_len):
    """B5 at PE-Core's head size (64) and token count (577 of 584), and at
    more heads over fewer keys."""
    from ovo_tpu_torch.models.layers import rope2d_freqs

    hd = 64
    D = heads * hd
    rng = np.random.default_rng(50 + heads)
    qkv = _bf16(rng, B, L, 3 * D)
    cos, sin = rope2d_freqs(24, 24, hd, n_prefix=1)
    pad = cos.new_zeros((max(0, L - cos.shape[0]), hd // 2))
    cos, sin = torch.cat([cos, pad])[:L], torch.cat([sin, pad])[:L]
    ref = A.rope_packed_attention_plain(qkv, cos, sin, heads=heads,
                                        kv_len=kv_len)
    q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    q, k = A.apply_rope(q, cos, sin), A.apply_rope(k, cos, sin)
    perm = torch.from_numpy(rng.permutation(L))
    keep = (perm < kv_len)[None, None, None, :]
    reordered = A.xla_attention(q, _permuted(k, perm), _permuted(v, perm),
                                mask=keep, scale=hd ** -0.5)
    reordered = reordered.transpose(1, 2).reshape(B, L, D)
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.ATTN_SHARE
    wrong = chip_smoke.rope_packed_unrounded_weights(qkv, cos, sin,
                                                     heads=heads,
                                                     kv_len=kv_len)
    # B5's max-abs limit (1e-2) alone passes the unrounded weights
    assert float((wrong.float() - ref.float()).abs().max()) <= 1e-2
    assert share(wrong, ref) > chip_smoke.ATTN_SHARE


@pytest.mark.parametrize("layout", ["path", "dense"])
def test_masked_pool_share_tells_rounded_weights_apart(layout):
    """B6 at TextRegion's shape (96 masks, 16 heads of 64, 48 x 72 tokens,
    15%-dense masks, the last 30 slots padding). The path's layout (one
    probe query, k constant over the tokens) gives every token of a row
    the same weight, so rounding the weights once scales a row's output by
    at most 2^-9 and moves no output by more than a step: the path cannot
    tell the two functions apart. The dense layout (random q and k) can:
    there the once-rounded weights break ATTN_SHARE while a reordered f32
    sum stays under it, and the max-abs limit (4e-3) passes both."""
    M, H, hd, L = 96, 16, 64, 48 * 72
    rng = np.random.default_rng(60)
    if layout == "path":
        q = _bf16(rng, 1, H, hd).expand(M, H, hd).contiguous()
        k = _bf16(rng, H, 1, hd).expand(H, L, hd)
    else:
        q, k = _bf16(rng, M, H, hd), _bf16(rng, H, L, hd)
    v = _bf16(rng, L, H, hd).transpose(0, 1)
    mask = torch.from_numpy(rng.random((M, L)) < 0.15)
    mask[-30:] = False
    ref = M_.masked_pool_plain(q, k, v, mask, hd ** -0.5)
    perm = torch.from_numpy(rng.permutation(L))
    reordered = M_.masked_pool_plain(q, k[:, perm], v[:, perm],
                                     mask[:, perm], hd ** -0.5)
    wrong = chip_smoke.masked_pool_rounded_weights(q, k, v, mask, hd ** -0.5)
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.ATTN_SHARE
    assert float((wrong.float() - ref.float()).abs().max()) <= 4e-3
    if layout == "path":
        assert share(wrong, ref) <= chip_smoke.ATTN_SHARE
    else:
        assert share(wrong, ref) > chip_smoke.ATTN_SHARE


@pytest.mark.parametrize("B,Bk,L", [(8, 8, 6400), (16, 1, 4096)])
def test_cross_small_head_share_tells_unrounded_weights_apart(B, Bk, L):
    """B9a at the 1280^2 decoder's widths (8 heads of 16, 8 tokens) over
    thousands of image rows, per-prompt and shared: a reordered f32 sum of
    the right function moved 1.8e-4 of the outputs by more than a step,
    the unrounded weights 0.13 (a CPU run at B 16 / 32, L 6400), which the
    max-abs limit (1e-2) alone passes."""
    heads, T, D = 8, 8, 128
    rng = np.random.default_rng(70 + Bk)
    q, k, v = _bf16(rng, B, T, D), _bf16(rng, Bk, L, D), _bf16(rng, Bk, L, D)
    ref = A.cross_attention_small_head_plain(q, k, v, heads)
    perm = torch.from_numpy(rng.permutation(L))
    reordered = A.cross_attention_small_head_plain(q, k[:, perm], v[:, perm],
                                                   heads)
    wrong = chip_smoke.cross_small_head_unrounded_weights(q, k, v, heads)
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.ATTN_SHARE
    assert float((wrong.float() - ref.float()).abs().max()) <= 1e-2
    assert share(wrong, ref) > chip_smoke.ATTN_SHARE



def _small_head_i2t_mma(qq, kk, vv, heads, t_len, truncate):
    """B9b's bf16 arithmetic as its tensor-core kernel does it: each head's
    16-column score one mma step (its exact sum rounded to f32 to nearest
    or, ``truncate``, toward zero, the way the mma accumulates), scaled;
    tokens past t_len at -1e30; p normalized, then rounded; p . v one mma
    step (the head's tokens)."""
    B, Lq, D = max(qq.shape[0], kk.shape[0]), qq.shape[1], qq.shape[2]
    dh = D // heads
    to_f32 = _toward_zero if truncate else (lambda t: t.float())

    def heads_of(t):
        h = t.reshape(t.shape[0], t.shape[1], heads, dh).transpose(1, 2)
        return h.expand((B,) + h.shape[1:]).double()

    s = to_f32(heads_of(qq) @ heads_of(kk).transpose(-1, -2)) * dh ** -0.5
    if t_len is not None:
        s[..., t_len:] = -1e30
    p = torch.softmax(s, dim=-1).to(BF).double()
    o = to_f32(p @ heads_of(vv)).to(BF)
    return o.transpose(1, 2).reshape(B, Lq, D)


@pytest.mark.parametrize("Bq,t_len", [(8, None), (8, 6), (1, None), (1, 5)])
def test_cross_small_head_i2t_share_tells_unrounded_weights_apart(Bq, t_len):
    """B9b at the 1280^2 decoder's widths (8 heads of 16, 8 tokens) over
    2048 image rows, per-prompt (Bq 8) and shared (Bq 1) q, all tokens or
    the first t_len: tokens permuted (with their k and v rows, the masked
    ones kept last) and the tensor-core kernel's mma steps (to nearest or
    toward zero; at most 5.2e-6 in a CPU run) stay under ATTN_SHARE; the
    normalized weights left in f32
    (chip_smoke.cross_small_head_i2t_unrounded_weights: 0.084-0.095) break
    it, which the max-abs limit (3e-2) alone passes."""
    heads, T, L, D, B = 8, 8, 2048, 128, 8
    rng = np.random.default_rng(90 + Bq + (t_len or 0))
    q, k, v = _bf16(rng, Bq, L, D), _bf16(rng, B, T, D), _bf16(rng, B, T, D)
    ref = A.cross_attention_small_head_plain(q, k, v, heads, t_len=t_len)
    live = T if t_len is None else t_len
    perm = torch.cat([torch.from_numpy(rng.permutation(live)),
                      torch.arange(live, T)])
    reordered = A.cross_attention_small_head_plain(q, k[:, perm], v[:, perm],
                                                   heads, t_len=t_len)
    share = chip_smoke.step_share
    assert share(reordered, ref) <= chip_smoke.ATTN_SHARE
    for truncate in (False, True):
        mma = _small_head_i2t_mma(q, k, v, heads, t_len, truncate)
        assert float((mma.float() - ref.float()).abs().max()) <= 3e-2
        assert share(mma, ref) <= chip_smoke.ATTN_SHARE / 10
    wrong = chip_smoke.cross_small_head_i2t_unrounded_weights(
        q, k, v, heads, t_len=t_len)
    assert float((wrong.float() - ref.float()).abs().max()) <= 3e-2
    assert share(wrong, ref) > chip_smoke.ATTN_SHARE

def _tf32x3_product(a, b):
    """a @ b as the kernel's tensor cores form it: each operand split into
    a TF32 hi part and a TF32 lo part, hi.hi + (hi.lo + lo.hi)."""
    def split(x):
        hi = chip_smoke.tf32_round(x)
        return hi, chip_smoke.tf32_round(x - hi)

    (ah, al), (bh, bl) = split(a), split(b)
    return torch.matmul(ah, bh) + (torch.matmul(ah, bl) + torch.matmul(al, bh))


def _fused_tf32x3(q, k, v, kv_len):
    s = _tf32x3_product(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    keep = torch.arange(k.shape[-2]) < kv_len
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return _tf32x3_product(e, v) / e.sum(dim=-1, keepdim=True)


def test_tf32_round_keeps_ten_mantissa_bits():
    """To nearest, ties away from zero (cvt.rna), the low 13 bits zero."""
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -20,
                      -(1.0 + 3 * 2.0 ** -11), 3.0])
    got = chip_smoke.tf32_round(x)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, -(1.0 + 2 * 2.0 ** -10), 3.0])
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("kv_len", [729, 629])
def test_b10_f32_limit_tells_one_tf32_pass_apart(kv_len):
    """B10 at the crop path's shape (one SigLIP-384 view: 16 heads x 729
    tokens x 72, N(0,1)): an emulated 3xTF32 kernel read 1.6e-6 / 1.8e-6
    against the plain f32 version (kv_len 729 / 629, a CPU run), one TF32
    product per f32 product 2.8e-4 / 3.6e-4: B10_F32_TOL (1e-5) passes the
    one and refuses the other."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 729, 72)).astype(
        np.float32)) for _ in range(3))
    ref = A.fused_attention_plain(q, k, v, kv_len=kv_len)
    x3 = _fused_tf32x3(q, k, v, kv_len)
    once = chip_smoke.fused_attention_tf32_once(q, k, v, kv_len)
    assert float((x3 - ref).abs().max()) <= chip_smoke.B10_F32_TOL / 4
    assert float((once - ref).abs().max()) > 20 * chip_smoke.B10_F32_TOL
