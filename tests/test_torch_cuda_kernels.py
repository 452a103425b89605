"""The hand-written CUDA kernels B5 (rope_packed_attention), B6
(masked_pool), B1-B4 (flash, windowed and the two decoder cross
attentions), B10 (fused_attention), B12a / B12b (fused_attn_block,
fused_mlp_block), the decoder's other routes' B7 (cross_i2t_proj), B8
(residual_layer_norm) and B9a / B9b (cross_small_head), and B14
(layer_norm_rows), B11 (packed_heads_attention) and B13 (fused_mask_tail)
(limits beside their tests below) against their plain PyTorch versions, on
a CUDA card; B2, B3 and B4 also at SAM1's 7 decoder tokens, and the SAM1
AMG program card against CPU. These tests skip without one (the kernels have no
CPU mode). The file imports
neither jax nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: 1e-4 abs in f32 (the kernels reorder the sums). In bf16 on
N(0,1) inputs B5 and its plain version both round the normalized softmax
weights to bf16 before p.v, as the reference does, so a weight on a
rounding edge may flip (2^-9 relative); B6 and its plain version both
keep the weights in f32 (the kernel as p_hi + p_lo); both round the output
to bf16. The outputs are softmax means of N(0,1) values: below 1 in
magnitude for B5 here (over 100-145 keys), where one bf16 step is at most
2^-8, and below 0.25 for B6 (over ~400 keys), where it is at most 2^-10.
The limits are those of chip_smoke.py: 1e-2 (B5) and 4e-3 (B6); B5 and B6
in bf16 also hold chip_smoke.ATTN_SHARE (below).
"""
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_SHARE, B3_SHARE, step_share
from ovo_tpu_torch.models.layers import rope2d_freqs
from ovo_tpu_torch.ops.attention import (rope_packed_attention,
                                         rope_packed_attention_plain)
from ovo_tpu_torch.ops.masked_pool import masked_pool, masked_pool_plain


def _rope_inputs(seed, B, H, hd, L, grid):
    rng = np.random.default_rng(seed)
    cos, sin = rope2d_freqs(grid, grid, hd, n_prefix=1)
    qkv = rng.standard_normal((B, L, 3 * H * hd)).astype(np.float32)
    return qkv, cos[:L].numpy(), sin[:L].numpy()


def _pool_inputs(seed, m, h, l, d, full_masked_rows=()):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((m, h, d)).astype(np.float32)
    k = rng.standard_normal((h, l, d)).astype(np.float32)
    v = rng.standard_normal((h, l, d)).astype(np.float32)
    mask = rng.random((m, l)) > 0.4
    mask[:, 0] = True
    for r in full_masked_rows:
        mask[r] = False
    return q, k, v, mask


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_rope_packed_kernel_matches_plain(cuda_device, dtype, tol):
    qkv, cos, sin = _rope_inputs(11, 3, 4, 64, 145, 12)
    q = torch.from_numpy(qkv).to(cuda_device, dtype)
    c = torch.from_numpy(cos).to(cuda_device)
    s = torch.from_numpy(sin).to(cuda_device)
    for kv_len in (None, 100):
        got = rope_packed_attention(q, c, s, heads=4, kv_len=kv_len)
        ref = rope_packed_attention_plain(q, c, s, heads=4, kv_len=kv_len)
        torch.cuda.synchronize()
        assert (got.float() - ref.float()).abs().max().item() <= tol
        # bf16: the weights round where the reference rounds them
        assert dtype != torch.bfloat16 or step_share(got, ref) <= ATTN_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 4e-3)])
def test_masked_pool_kernel_matches_plain(cuda_device, dtype, tol):
    q, k, v, mask = _pool_inputs(13, 40, 4, 700, 64, full_masked_rows=(3,))
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in (q, k, v)]
    m = torch.from_numpy(mask).to(cuda_device)
    got = masked_pool(*args, m, 0.125)
    ref = masked_pool_plain(*args, m, 0.125)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max().item() <= tol
    # bf16: the weights stay f32 in effect, as in the reference's kernel
    assert dtype != torch.bfloat16 or step_share(got, ref) <= ATTN_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_rope_packed_kernel_edges(cuda_device, dtype, tol, hd):
    """L = 145 (not a multiple of 16) and kv_len = 129: the last 64-key
    chunk holds one valid key."""
    heads, L, kv_len = 4, 145, 129
    qkv, cos, sin = _rope_inputs(17 + hd, 2, heads, hd, L, 12)
    q = torch.from_numpy(qkv).to(cuda_device, dtype)
    c = torch.from_numpy(cos).to(cuda_device)
    s = torch.from_numpy(sin).to(cuda_device)
    got = rope_packed_attention(q, c, s, heads=heads, kv_len=kv_len)
    ref = rope_packed_attention_plain(q, c, s, heads=heads, kv_len=kv_len)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max().item() <= tol
    assert dtype != torch.bfloat16 or step_share(got, ref) <= ATTN_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("M,L", [(40, 700), (40, 701), (150, 700)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 4e-3)])
def test_masked_pool_kernel_edges(cuda_device, dtype, tol, M, L):
    """B6's split grid: L not a multiple of the span (701 also takes the
    mask byte by byte), M not a multiple of 16 (150: two 128-mask
    groups), the second span masked in every row, fully masked rows, and
    TextRegion's stride-0 k with a head-transposed v."""
    from ovo_tpu_torch.ops.masked_pool import pool_span

    H, hd = 4, 64
    span = pool_span(M, H, L, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    assert L % span != 0 and -(-L // span) >= 3
    q, k, v, mask = _pool_inputs(19, M, H, L, hd, full_masked_rows=(3, 37))
    mask[:, span:2 * span] = False
    qd = torch.from_numpy(q).to(cuda_device, dtype)
    kb = torch.from_numpy(k[:, :1]).to(cuda_device, dtype).expand(H, L, hd)
    vt = torch.from_numpy(np.ascontiguousarray(v.transpose(1, 0, 2))).to(
        cuda_device, dtype).transpose(0, 1)
    md = torch.from_numpy(mask).to(cuda_device)
    for kk in (kb, torch.from_numpy(k).to(cuda_device, dtype)):
        got = masked_pool(qd, kk, vt, md, 0.125)
        ref = masked_pool_plain(qd, kk, vt, md, 0.125)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        assert (got.float() - ref.float()).abs().max().item() <= tol
        assert dtype != torch.bfloat16 or step_share(got, ref) <= ATTN_SHARE
        uniform = vt.float().mean(dim=1)
        for r in (3, 37):
            assert (got[r].float() - uniform).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# B1-B4 (the SAM2 automatic-mask path). Limits: 1e-4 abs in f32 (summation
# order). bf16: B1 and its plain version both keep the softmax weights in
# f32 and round once at the output, a softmax mean of N(0,1) values below 1
# here, where one bf16 step is at most 2^-8: 1e-2. B2, B3 and B4 round the
# normalized weights to bf16 on both sides, so a weight on a rounding edge
# can flip one step (2^-9 relative) and move the output a step: 1e-2 for
# B2; B4's output is a LayerNorm of order-1 values up to ~4, where one step
# is 2^-6, after two more roundings (attn, y): 6e-2; B3's output adds a
# N(0,1) bias, |out| < ~4, after pk is rounded: 3e-2. The limits are those
# of chip_smoke.py. B1, B2, B4 and B11 in bf16 also hold
# chip_smoke.ATTN_SHARE, B3 chip_smoke.B3_SHARE: the share of outputs off
# by more than one bf16 step, which the max-abs limit cannot bound (B1 with
# its weights rounded once, B3 with its weights unrounded, stay under it).
# ---------------------------------------------------------------------------

from ovo_tpu_torch.ops import attention as A  # noqa: E402


def _dev(x, dev, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)


def _err(got, ref):
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    return (got.float() - ref.float()).abs().max().item()


def _mismatch_share(got, ref, atol=2 ** -10):
    """The share of elements of got that differ from ref by more than
    atol."""
    return ((got.float() - ref.float()).abs() > atol).float().mean().item()


def _unaligned(t):
    """t's values in a view whose data pointer sits one element past a
    16-byte boundary and whose row stride is odd: the kernels must take it
    with their narrowest loads."""
    *lead, rows, cols = t.shape
    base = t.new_zeros((*lead, rows, cols + 3))
    view = base[..., 1:1 + cols]
    view.copy_(t)
    return view


def _shares_ok(got, ref, dtype, limit=ATTN_SHARE):
    """bf16: at most ``limit`` of the outputs off by more than a step (the
    limits chip_smoke.py holds B1-B5 and B11 to)."""
    return dtype != torch.bfloat16 or step_share(got, ref) <= limit


def _misaligned(t):
    """t's values in a contiguous view whose data pointer sits one element
    past a 16-byte boundary."""
    base = t.new_empty(t.numel() + 1)
    view = base[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_flash_kernel_matches_plain(cuda_device, dtype, tol):
    rng = np.random.default_rng(21)
    # 64-key tiles: L 4096 and a non-multiple (300); head sizes padded to
    # 16 in shared memory (72, 40), exact (64, 128), odd or a multiple of 4
    # only (33, 20: narrower loads); kv_len masking part of a tile, and
    # part of a tile plus a whole one
    for hd, L in ((72, 4096), (72, 300), (64, 300), (40, 300), (128, 300),
                  (33, 129), (20, 129)):
        # head-split views of a packed (B, L, 3, H, hd) projection
        qkv = _dev(rng.standard_normal((2, L, 3, 3, hd)), cuda_device, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        # ... a whole number of tiles, and a single key
        for kv_len in (None, L - 50, L - 90, (L - 1) // 64 * 64, 1):
            got = A.flash_attention(q, k, v, kv_len=kv_len)
            ref = A.flash_attention_plain(q, k, v, kv_len=kv_len)
            assert _err(got, ref) <= tol
            assert _shares_ok(got, ref, dtype)
        # fewer queries than keys
        got = A.flash_attention(q[:, :, :L // 3], k, v, kv_len=L - 50)
        ref = A.flash_attention_plain(q[:, :, :L // 3], k, v, kv_len=L - 50)
        assert _err(got, ref) <= tol
    # a view that is not 16-byte aligned takes the narrow loads
    qu, ku, vu = (_unaligned(t) for t in (q, k, v))
    got = A.flash_attention(qu, ku, vu, kv_len=L - 50)
    ref = A.flash_attention_plain(q, k, v, kv_len=L - 50)
    assert _err(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_windowed_kernel_matches_plain(cuda_device, dtype, tol):
    rng = np.random.default_rng(22)
    cases = [(20, 3, 16, 64, 72), (2, 4, 196, 196, 72), (50, 2, 4, 16, 72),
             (64, 8, 8, 8, 32), (3, 2, 49, 196, 72)]
    # every head size at the trunk's, decoder's and text tower's lengths, q
    # shorter than k, up to 512 keys
    for hd in A.WINDOWED_HEAD_DIMS:
        for lq, lk in ((4, 16), (8, 8), (16, 64), (49, 196), (64, 64),
                       (196, 196), (64, 512)):
            cases.append((3, 2, lq, lk, hd))
    for B, H, lq, lk, hd in cases:
        q = _dev(rng.standard_normal((B, lq, H, hd)), cuda_device,
                 dtype).transpose(1, 2)
        k, v = (_dev(rng.standard_normal((B, H, lk, hd)), cuda_device, dtype)
                for _ in range(2))
        q[1], k[1] = 0, 0                    # a padded instance
        for kv_len in (None, 1, lk - 3):
            got = A.windowed_fused_attention(q, k, v, kv_len=kv_len)
            ref = A.windowed_attention_plain(q, k, v, kv_len=kv_len)
            assert _err(got, ref) <= tol
            assert _shares_ok(got, ref, dtype)
        # the padded instance: the mean of v over the kv_len - 3 keys
        mean = v[1, :, :lk - 3].float().mean(dim=1, keepdim=True)
        assert (got[1].float() - mean).abs().max().item() <= tol
    # a view that is not 16-byte aligned takes the narrow loads
    qu, ku, vu = (_unaligned(t) for t in (q, k, v))
    got = A.windowed_fused_attention(qu, ku, vu)
    assert _err(got, A.windowed_attention_plain(q, k, v)) <= tol


def _cross_args(rng, dev, dtype, B, Bk, T, L, heads=8, D=128, dk=256):
    f = np.float32
    return dict(
        q=_dev(rng.standard_normal((B, T, D)), dev, dtype),
        keys=_dev(rng.standard_normal((Bk, L, dk)), dev, dtype),
        wk=_dev(rng.standard_normal((dk, D)) * dk ** -0.5, dev, dtype),
        wv=_dev(rng.standard_normal((dk, D)) * dk ** -0.5, dev, dtype),
        pe=_dev(rng.standard_normal((1, L, D)), dev, dtype),
        bv=_dev(rng.standard_normal(D), dev, torch.float32),
        wout=_dev(rng.standard_normal((D, dk)) * D ** -0.5, dev, dtype),
        bout=_dev(rng.standard_normal(dk).astype(f), dev, torch.float32),
        g=_dev(rng.random(dk) + 0.5, dev, torch.float32),
        b=_dev(rng.standard_normal(dk), dev, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cross_t2i_kernel_matches_plain(cuda_device, dtype, tol):
    rng = np.random.default_rng(23)
    # (prompts, keys batch, tokens, heads, L, dk, D): shared and per-prompt
    # keys, L a whole number of 64-key chunks or not, dk 128 and 256,
    # 64 rows of 8 x 8 or 4 x 16, 40 rows (5 tokens: a row tile straddles
    # heads, the last one half empty), 60 rows of 12 heads of 8, and D 72
    # (heads of 9: zero-padded to 80 columns)
    for B, Bk, T, heads, L, dk, D in ((5, 1, 8, 8, 300, 256, 128),
                                      (5, 5, 8, 8, 300, 256, 128),
                                      (3, 3, 8, 8, 4096, 256, 128),
                                      (4, 1, 16, 4, 130, 128, 128),
                                      (4, 4, 5, 8, 100, 128, 128),
                                      (3, 3, 5, 12, 130, 256, 96),
                                      (3, 1, 8, 8, 70, 128, 72)):
        x = _cross_args(rng, cuda_device, dtype, B, Bk, T, L, heads=heads,
                        dk=dk, D=D)
        args = (x["q"], x["keys"], x["wk"], x["wv"], x["pe"], x["bv"], heads)
        got = A.cross_t2i_from_keys(*args)
        ref = A.cross_t2i_from_keys_plain(*args)
        assert _err(got, ref) <= tol
        assert _shares_ok(got, ref, dtype, B3_SHARE)
    # keys whose pointer is not 16-byte aligned are taken
    got = A.cross_t2i_from_keys(args[0], _misaligned(args[1]), *args[2:])
    assert _err(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6e-2)])
def test_cross_i2t_tail_kernel_matches_plain(cuda_device, dtype, tol):
    rng = np.random.default_rng(24)
    # (token batch, keys batch, tokens, t_len, heads, rows, dk, D): shared
    # keys, per-prompt keys with masked tokens, shared tokens with fewer
    # than 64 token rows, L 4096, dk 128, 16 tokens a head (two n8 tiles),
    # 5 tokens (a head padded to 8), 2 and 3 tokens (heads sharing a quad),
    # score columns past 64 (12 heads x 8, 5 heads x 16), D 72 (its last
    # k16 chunk half empty)
    for Bt, Bk, T, t_len, heads, L, dk, D in (
            (3, 1, 8, None, 8, 100, 256, 128), (3, 3, 8, 6, 8, 300, 256, 128),
            (1, 3, 5, 4, 8, 130, 256, 128), (2, 2, 8, None, 8, 4096, 256, 128),
            (3, 3, 8, 7, 8, 300, 128, 128), (2, 1, 16, 11, 4, 130, 256, 128),
            (2, 2, 5, None, 8, 64, 128, 128), (2, 2, 2, None, 8, 130, 128, 128),
            (2, 1, 3, 2, 8, 100, 256, 128), (2, 2, 5, 4, 12, 130, 256, 96),
            (1, 2, 9, 7, 5, 64, 128, 80), (2, 2, 8, 5, 6, 70, 256, 72)):
        x = _cross_args(rng, cuda_device, dtype, Bt, Bk, T, L, heads=heads,
                        dk=dk, D=D)
        vv = x["q"].flip(1).contiguous()
        args = (x["keys"], x["wk"], x["pe"], x["q"], vv, x["wout"],
                x["bout"], x["g"], x["b"], heads)
        got = A.cross_i2t_tail_from_keys(*args, t_len=t_len)
        ref = A.cross_i2t_tail_from_keys_plain(*args, t_len=t_len)
        assert _err(got, ref) <= tol
        assert _shares_ok(got, ref, dtype)
    # keys whose pointer is not 16-byte aligned are taken
    got = A.cross_i2t_tail_from_keys(_misaligned(args[0]), *args[1:])
    assert _err(got, A.cross_i2t_tail_from_keys_plain(*args)) <= tol


# ---------------------------------------------------------------------------
# SAM1's decoder runs 7 tokens (IoU, 4 mask tokens, the point, the pad
# point). B3's fixed-width instance takes them (and fewer) in the row
# layout of 8 tokens, the tail rows unread and unstored. B4 rounds 7 up to 8 token
# columns, the eighth masked. B2 takes the token self-attention's
# head-split views (lq = lk = 7). The limits are those of the 8-token tests
# above; the SAM1 AMG program on vit_test, card against CPU, is
# chip_smoke.py's reference_sam1.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cross_t2i_kernel_at_sam1_tokens(cuda_device, dtype, tol):
    from ovo_tpu_torch.ops import cuda_build

    rng = np.random.default_rng(26)
    # SAM1's 7 tokens, and 3 (a row tile of two heads' 3 rows and 5 unused)
    for Bk, T in ((1, 7), (6, 7), (6, 3)):
        x = _cross_args(rng, cuda_device, dtype, 6, Bk, T, 4096)
        args = (x["q"], x["keys"], x["wk"], x["wv"], x["pe"], x["bv"], 8)
        ref = A.cross_t2i_from_keys_plain(*args)
        cuda_build.reset_launch_counts()
        got = A.cross_t2i_from_keys(*args)
        assert cuda_build.launch_counts()["cross_t2i"] == 1
        assert tuple(got.shape) == tuple(ref.shape) == (6, T, 128)
        assert _err(got, ref) <= tol
        assert _shares_ok(got, ref, dtype, B3_SHARE)
        if dtype == torch.bfloat16:
            # the masked tail rows are the zero rows of an 8-token call
            q8 = torch.nn.functional.pad(x["q"], (0, 0, 0, 8 - T))
            full = A.cross_t2i_from_keys(q8, *args[1:])
            assert torch.equal(full[:, :T], got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6e-2)])
def test_cross_i2t_tail_kernel_at_sam1_tokens(cuda_device, dtype, tol):
    rng = np.random.default_rng(27)
    for Bt, Bk, t_len in ((6, 1, None), (6, 6, None), (6, 6, 5)):
        x = _cross_args(rng, cuda_device, dtype, Bt, Bk, 7, 4096)
        args = (x["keys"], x["wk"], x["pe"], x["q"],
                x["q"].flip(1).contiguous(), x["wout"], x["bout"], x["g"],
                x["b"], 8)
        got = A.cross_i2t_tail_from_keys(*args, t_len=t_len)
        ref = A.cross_i2t_tail_from_keys_plain(*args, t_len=t_len)
        assert _err(got, ref) <= tol
        assert _shares_ok(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_windowed_kernel_at_sam1_tokens(cuda_device, dtype, tol):
    """The decoder's token self-attention: q, k, v each a (B, 7, 256)
    projection, split into 8 heads of 32 (strided views)."""
    rng = np.random.default_rng(28)
    assert A.attention_route(7, 7, 32) == "windowed"
    q, k, v = (_dev(rng.standard_normal((64, 7, 256)), cuda_device,
                    dtype).reshape(64, 7, 8, 32).transpose(1, 2)
               for _ in range(3))
    ref = A.windowed_attention_plain(q, k, v)
    for got in (A.dot_product_attention(q, k, v),
                A.windowed_fused_attention(q, k, v)):
        assert _err(got, ref) <= tol
        assert _shares_ok(got, ref, dtype)


@pytest.mark.cuda
def test_sam1_amg_program_card_matches_cpu(cuda_device):
    import chip_smoke

    r = chip_smoke.run_reference_amg(cuda_device, "vit_test", min_area=100)
    assert r["valid_masks"] >= 1
    assert r["launches"] == {"windowed_attention": 2, "cross_t2i": 3,
                             "cross_i2t_tail": 2}


# ---------------------------------------------------------------------------
# B10 (the SigLIP image towers). Limits: f32 runs as 3xTF32 on the tensor
# cores and is held to chip_smoke.B10_F32_TOL (1e-5), which one TF32 product
# per f32 product breaks (tests/test_torch_attention_share.py); the 1e-4 of
# the other f32 kernels would not tell the two apart. bf16 1e-2: kernel and
# plain version both round the normalized weights to bf16 before p.v, so a
# weight on a rounding edge can move the output one bf16 step (2^-8 at
# |out| < 1), as for B2, and ATTN_SHARE. The limits are those of
# chip_smoke.py.
# ---------------------------------------------------------------------------

from chip_smoke import B10_F32_TOL  # noqa: E402


def _b10_check(q, k, v, kv_len, dtype):
    got = A.fused_attention(q, k, v, kv_len=kv_len)
    ref = A.fused_attention_plain(q, k, v, kv_len=kv_len)
    assert _err(got, ref) <= (B10_F32_TOL if dtype == torch.float32
                              else 1e-2)
    assert _shares_ok(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(25)
    for B, H, L, hd in ((2, 3, 729, 72), (1, 2, 1024, 128), (3, 2, 257, 80),
                        (2, 1, 300, 16)):
        # head-split views of a packed (B, L, 3, H, hd) projection
        qkv = _dev(rng.standard_normal((B, L, 3, H, hd)), cuda_device, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        for kv_len in (None, L - 100):
            _b10_check(q, k, v, kv_len, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 72, 80, 40])
@pytest.mark.parametrize("L", [256, 729, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_edges(cuda_device, dtype, L, hd):
    """The compile-time widths (64, 72, 80) and a padded one (40: f32 in the
    64 instantiation, bf16 padded to B2's 48); kv_len leaving one key in
    the last chunk (32 keys in f32, 64 in bf16), or keys past L - 100;
    fewer queries than keys, not a multiple of 16; strided head views."""
    rng = np.random.default_rng(hd + L)
    qkv = _dev(rng.standard_normal((2, L, 3, 3, hd)), cuda_device, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    for kv_len in (None, (L - 2) // 64 * 64 + 1, L - 100):
        _b10_check(q, k, v, kv_len, dtype)
    _b10_check(q[:, :, :L - 37], k, v, L - 5, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_at_the_crop_shape(cuda_device, dtype, batch):
    """SigLIP-384's global view and 96 crops (16 heads of 72, 729 tokens),
    and an odd head size (33: 4-byte copies in f32, padded to 48 in bf16)
    on contiguous operands."""
    rng = np.random.default_rng(batch)
    qkv = _dev(rng.standard_normal((batch, 729, 3, 16, 72)), cuda_device,
               dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    for kv_len in (None, 705):
        _b10_check(q, k, v, kv_len, dtype)
    q, k, v = (_dev(rng.standard_normal((1, 2, 300, 33)), cuda_device, dtype)
               for _ in range(3))
    _b10_check(q, k, v, 289, dtype)


# ---------------------------------------------------------------------------
# B12a / B12b (the whole-block tower path, OVO_FUSED_BLOCK=1). Limits: 1e-4
# abs in f32 (sums in another order); bf16 6e-2: the outputs are x plus the
# block half, below ~8 in magnitude here, where one bf16 step is up to
# 2^-5, and intermediates rounded on an edge (LN, q, k, v, p, heads, hidden)
# move them by a few 2^-8 more. The limits are those of chip_smoke.py; in
# bf16 both also hold chip_smoke.B12_SHARE, which the max-abs limit cannot
# bound (B12b with h left in f32 stays under it). The shapes cover every
# route the kernels report (attn_block_routes / mlp_block_routes).
# ---------------------------------------------------------------------------

from chip_smoke import B12_SHARE  # noqa: E402
from ovo_tpu_torch.ops import fused_block as FB  # noqa: E402


def _block_weights(rng, dev, dtype, D, heads, hidden):
    hd = D // heads

    def w(*shape, std):
        return _dev(rng.standard_normal(shape) * std, dev, dtype)

    def f(*shape, std=0.1, mean=0.0):
        return _dev(rng.standard_normal(shape) * std + mean, dev,
                    torch.float32)

    return dict(w=w(heads, D, 3 * hd, std=D ** -0.5), b=f(heads, 3 * hd),
                ow=w(heads, hd, D, std=D ** -0.5), ob=f(D),
                ls=f(D, mean=1.0), lb=f(D),
                fc=w(D, hidden, std=D ** -0.5), fcb=f(hidden),
                pw=w(hidden, D, std=hidden ** -0.5), pb=f(D))


def _check_block(got, ref, dtype, tol, case):
    err = _err(got, ref)
    share = step_share(got, ref) if dtype == torch.bfloat16 else 0.0
    assert err <= tol and share <= B12_SHARE, (case, err, share)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6e-2)])
def test_fused_attn_block_kernel_matches_plain(cuda_device, dtype, tol):
    rng = np.random.default_rng(26)
    seen = {"qkv": set(), "attention": set(), "out": set()}
    # (views, tokens, real tokens, width, heads, causal, rope): the PE shape
    # (M = 1154, not a multiple of the 128-row tile), a causal masked block
    # with 16-wide heads, odd lengths, one token, 1024 tokens with masked
    # keys, RoPE off on the tensor-core route, causal with tensor-core
    # GEMMs, hd 128 and 32 (the f32 scratch route)
    for B, L, l_real, D, H, causal, rope in (
            (2, 577, 577, 1024, 16, False, True),
            (3, 150, 131, 64, 4, True, False),
            (1, 37, 30, 192, 3, False, True),
            (2, 1, 1, 128, 2, False, True),
            (1, 1024, 1000, 256, 4, False, True),
            (2, 150, 131, 128, 2, False, False),
            (3, 150, 131, 128, 2, True, True),
            (2, 577, 577, 1024, 8, False, True),
            (2, 150, 140, 256, 8, False, True)):
        p = _block_weights(rng, cuda_device, dtype, D, H, 4 * D)
        x = _dev(rng.standard_normal((B, L, D)), cuda_device, dtype)
        if L == 150 and D == 256:  # x off a 16-byte boundary: FMA out
            x = _misaligned(x)
        cos = _dev(rng.standard_normal((L, D // H // 2)), cuda_device,
                   torch.float32)
        sin = _dev(rng.standard_normal((L, D // H // 2)), cuda_device,
                   torch.float32)
        args = (x, p["w"], p["b"], p["ow"], p["ob"], p["ls"], p["lb"], cos,
                sin)
        kw = dict(n_heads=H, L_real=l_real, causal=causal, use_rope=rope)
        for k, v in FB.attn_block_routes(x, p["w"], p["ow"], n_heads=H,
                                         causal=causal).items():
            seen[k].add(v)
        _check_block(FB.fused_attn_block(*args, **kw),
                     FB.fused_attn_block_plain(*args, **kw), dtype, tol,
                     (B, L, l_real, D, H, causal, rope))
    assert seen == ({"qkv": {"mma_rope", "fma"}, "attention": {"mma", "fma"},
                     "out": {"mma", "fma"}} if dtype == torch.bfloat16 else
                    {"qkv": {"fma"}, "attention": {"fma"}, "out": {"fma"}})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6e-2)])
def test_fused_mlp_block_kernel_matches_plain(cuda_device, dtype, tol):
    rng = np.random.default_rng(27)
    seen = set()
    # hidden / chunk 4096 / 512 (the PE tower), 4096 / 1024, 768 / 384;
    # widths the tensor-core tile does not take (D 64, 192, 72) on either
    # GEMM; one token; 1024 tokens
    for B, L, D, hidden, chunk, act in ((2, 577, 1024, 4096, 512, "gelu"),
                                        (3, 150, 64, 256, 256, "quick_gelu"),
                                        (1, 37, 192, 768, 384, "gelu"),
                                        (2, 150, 1024, 4096, 1024, "gelu"),
                                        (2, 1, 128, 768, 384, "gelu"),
                                        (1, 1024, 256, 1024, 512, "gelu"),
                                        (3, 100, 72, 288, 96, "quick_gelu")):
        p = _block_weights(rng, cuda_device, dtype, D, 1, hidden)
        x = _dev(rng.standard_normal((B, L, D)), cuda_device, dtype)
        if L == 1024:  # x off a 16-byte boundary: the proj on FMAs
            x = _misaligned(x)
        args = (x, p["fc"], p["fcb"], p["pw"], p["pb"], p["ls"], p["lb"])
        seen.update(FB.mlp_block_routes(x, p["fc"], p["pw"], chunk).items())
        _check_block(FB.fused_mlp_block(*args, act=act, chunk=chunk),
                     FB.fused_mlp_block_plain(*args, act=act, chunk=chunk),
                     dtype, tol, (B, L, D, hidden, chunk, act))
    assert seen == ({("fc", "mma"), ("fc", "fma"), ("proj", "mma"),
                     ("proj", "fma")} if dtype == torch.bfloat16 else
                    {("fc", "fma"), ("proj", "fma")})


@pytest.mark.cuda
def test_fused_block_wrappers_raise_on_what_the_kernels_do_not_take(
        cuda_device):
    x = torch.zeros((1, 1100, 64), device=cuda_device)
    p = _block_weights(np.random.default_rng(0), cuda_device, torch.float32,
                       64, 4, 256)
    z = torch.zeros((1100, 8), device=cuda_device)
    with pytest.raises(ValueError, match="L <= 1024"):
        FB.fused_attn_block(x, p["w"], p["b"], p["ow"], p["ob"], p["ls"],
                            p["lb"], z, z, n_heads=4, L_real=1100,
                            causal=False, use_rope=False)
    with pytest.raises(ValueError, match="f32"):
        FB.fused_mlp_block(x[:, :8], p["fc"], p["fcb"].half(), p["pw"],
                           p["pb"], p["ls"], p["lb"], chunk=256)


# ---------------------------------------------------------------------------
# B9a / B9b (cross_small_head), B7 (cross_i2t_proj), B8 (residual_layer_norm):
# the decoder's unfused and proj routes. Limits: 1e-4 abs in f32 (sums in
# another order). bf16: B9a / B9b and B7 round the normalized weights on both
# sides, as the reference does, so a weight on a rounding edge can move an
# output a step; the outputs are softmax means of N(0,1) values, below 1
# for B9a (over hundreds of image rows), where one bf16 step is at most
# 2^-8: 1e-2; below 4 for B9b / B7 (over a few tokens), where it is 2^-6:
# 3e-2. B8's output is a LayerNorm of order-1 values times a scale up to
# 1.5 plus an N(0,1) bias, below 8, where one step is 2^-5; both sides
# round one f32 value, so they differ by at most a step: 6e-2 (as B4). The
# limits are those of chip_smoke.py.
# ---------------------------------------------------------------------------

def _b9a_check(rng, dev, dtype, tol, B, Bk, T, L, heads):
    D = 16 * heads
    q = _dev(rng.standard_normal((B, T, D)), dev, dtype)
    k, v = (_dev(rng.standard_normal((Bk, L, D)), dev, dtype)
            for _ in range(2))
    got = A.cross_attention_small_head(q, k, v, heads)
    ref = A.cross_attention_small_head_plain(q, k, v, heads)
    assert _err(got, ref) <= tol
    # bf16: the normalized weights round, as the reference rounds them
    assert _shares_ok(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_cross_small_head_t2i_kernel_matches_plain(cuda_device, dtype, tol):
    rng = np.random.default_rng(28)
    # (prompts, image batch, tokens, image rows, heads): shared and
    # per-prompt image sides, 11 tokens (88 rows: two row blocks), 4 heads
    for B, Bk, T, L, heads in ((5, 1, 8, 300, 8), (5, 5, 8, 257, 8),
                               (3, 3, 11, 200, 8), (2, 1, 7, 130, 4)):
        _b9a_check(rng, cuda_device, dtype, tol, B, Bk, T, L, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("T,heads", [(1, 8), (8, 1), (9, 16), (16, 3),
                                     (33, 8), (64, 2)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_cross_small_head_t2i_kernel_edges(cuda_device, dtype, tol, T, heads):
    """Token counts 1 to 64 (bf16: one or four 16-token tiles, the rows
    8-15 of a tile used or not), heads 1 to 16, image sides that are not a
    multiple of the 64-row tile (6337 and 65: one row in the last tile),
    shared and per-prompt."""
    rng = np.random.default_rng(T * 17 + heads)
    for B, Bk, L in ((3, 1, 6337), (3, 3, 65), (2, 2, 1000)):
        _b9a_check(rng, cuda_device, dtype, tol, B, Bk, T, L, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cross_small_head_i2t_kernel_matches_plain(cuda_device, dtype, tol):
    """A shared image side with per-prompt tokens (the first layer),
    per-prompt both, masked tokens, shared tokens; 8, 5, 16, 11, 3 tokens
    with t_len below them; image sides that are not a multiple of the
    16-row tile; the decoder's 8 heads and 4, 5 or 1 (the tensor cores'
    run-time widths); bf16 also within ATTN_SHARE. At 20 tokens or 12 heads
    (D 192), outside the tensor-core tile, and in f32 the entry point takes
    i2t_kernel: the call's trace names the kernel that ran."""
    from torch.profiler import ProfilerActivity, profile

    from ovo_tpu_torch.ops import cuda_build

    def traced(fn):
        # a trace now and then comes back without the card's events
        for _ in range(3):
            cuda_build.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type.name == "CUDA"]
            if names:
                return out, names
        raise AssertionError("torch.profiler recorded no kernel")

    rng = np.random.default_rng(29)
    # (prompts, image batch, tokens, t_len, heads, image rows, route in bf16)
    for Bt, Bq, T, t_len, heads, L, route in (
            (4, 1, 8, None, 8, 300, "mma"), (4, 4, 8, 6, 8, 129, "mma"),
            (1, 3, 11, None, 8, 200, "mma"), (3, 3, 5, 4, 8, 1000, "mma"),
            (2, 1, 16, 11, 8, 6401, "mma"), (2, 2, 16, None, 8, 77, "mma"),
            (3, 3, 8, 7, 4, 257, "mma"), (2, 1, 11, 9, 5, 130, "mma"),
            (2, 2, 3, 2, 1, 65, "mma"), (2, 2, 20, 17, 8, 300, "fma"),
            (2, 1, 8, None, 12, 200, "fma")):
        D = 16 * heads
        q = _dev(rng.standard_normal((Bq, L, D)), cuda_device, dtype)
        k, v = (_dev(rng.standard_normal((Bt, T, D)), cuda_device, dtype)
                for _ in range(2))
        got, names = traced(lambda: A.cross_attention_small_head(
            q, k, v, heads, t_len=t_len))
        assert cuda_build.launch_counts()["cross_small_head_i2t"] == 1
        # one i2t kernel ran, and it is the tensor cores' where expected
        assert [("small_i2t_mma_kernel" in n) for n in names
                if "i2t" in n] == [route == "mma"
                                   and dtype == torch.bfloat16], names
        ref = A.cross_attention_small_head_plain(q, k, v, heads, t_len=t_len)
        assert got.shape == ref.shape == (max(Bt, Bq), L, D)
        assert _err(got, ref) <= tol
        assert _shares_ok(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cross_i2t_proj_kernel_matches_plain(cuda_device, dtype, tol):
    """B4's shapes (test_cross_i2t_tail_kernel_matches_plain): the bf16
    kernel is B4's front half (the decoder's widths, 16 tokens a head, 2, 3
    and 5 tokens, score columns past 64, dk 128, D 72 / 80 / 96), and also
    holds ATTN_SHARE; keys at an odd element offset are taken."""
    rng = np.random.default_rng(30)
    for Bt, Bk, T, t_len, heads, L, dk, D in (
            (3, 1, 8, None, 8, 100, 256, 128), (3, 3, 8, 6, 8, 300, 256, 128),
            (1, 3, 5, 4, 8, 130, 256, 128), (2, 2, 8, None, 8, 4096, 256, 128),
            (3, 3, 8, 7, 8, 300, 128, 128), (2, 1, 16, 11, 4, 130, 256, 128),
            (2, 2, 5, None, 8, 64, 128, 128), (2, 2, 2, None, 8, 130, 128, 128),
            (2, 1, 3, 2, 8, 100, 256, 128), (2, 2, 5, 4, 12, 130, 256, 96),
            (1, 2, 9, 7, 5, 64, 128, 80), (2, 2, 8, 5, 6, 70, 256, 72)):
        x = _cross_args(rng, cuda_device, dtype, Bt, Bk, T, L, heads=heads,
                        dk=dk, D=D)
        vv = x["q"].flip(1).contiguous()
        args = (x["keys"], x["wk"], x["pe"], x["q"], vv, heads)
        got = A.cross_i2t_from_keys(*args, t_len=t_len)
        ref = A.cross_i2t_from_keys_plain(*args, t_len=t_len)
        assert got.shape == ref.shape
        assert _err(got, ref) <= tol
        assert _shares_ok(got, ref, dtype)
    got = A.cross_i2t_from_keys(_misaligned(args[0]), *args[1:])
    assert _err(got, A.cross_i2t_from_keys_plain(*args)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6e-2)])
def test_residual_layer_norm_kernel_matches_plain(cuda_device, dtype, tol):
    from ovo_tpu_torch.ops.layer_norm import (residual_layer_norm,
                                              residual_layer_norm_plain)

    rng = np.random.default_rng(31)
    for B, Br, L, C in ((4, 1, 300, 256), (3, 3, 129, 256), (2, 1, 7, 1024),
                        (2, 2, 33, 68)):
        x, r = (_dev(rng.standard_normal((b, L, C)), cuda_device, dtype)
                for b in (B, Br))
        g = _dev(rng.random(C) + 0.5, cuda_device, torch.float32)
        b = _dev(rng.standard_normal(C), cuda_device, torch.float32)
        assert _err(residual_layer_norm(x, r, g, b),
                    residual_layer_norm_plain(x, r, g, b)) <= tol


# ---------------------------------------------------------------------------
# B14 (layer_norm_rows), B11 (packed_heads_attention) and B13
# (fused_mask_tail): the kernels the reference wires into no route. Limits:
# 1e-4 abs in f32 (sums in another order). bf16: B14 as B8 (a LayerNorm
# times a scale up to 1.5 plus an N(0,1) bias, below 8, one f32 value
# rounded on both sides: 6e-2); B11 as B2 (both sides round the normalized
# weights: 1e-2). B13 is bf16 only: its f32 product over c1 is summed in
# another order than the plain version's matmul, so a product on a bf16
# rounding edge moves one gelu output a step (at most 2^-5 for |y| < 8),
# times |hyper| < 4 in the hypernet dot: 0.125. That limit alone would
# pass a tail whose gelu computes in f32 and rounds once (F.gelu: 0.118 from
# the op-by-op tail at the AMG shape), a different function; so the share of
# outputs off by more than 2^-10 is also bounded, by 1e-3: such flips touch
# a few outputs in 10^5, the once-rounded gelu about 90% of them. The
# limits are those of chip_smoke.py.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_entry_launches_on_the_current_device_and_stream(cuda_device):
    """cuda_build.Entry's device and stream queries (torch's private
    raw-stream query where this torch has it) name what torch.cuda does,
    on the default stream and inside a side stream, whose launch then
    runs there."""
    from ovo_tpu_torch.ops import cuda_build
    from ovo_tpu_torch.ops.layer_norm import (layer_norm_rows,
                                              layer_norm_rows_plain)

    index = torch.cuda.current_device()
    assert cuda_build._current_device() == index
    assert cuda_build._current_raw_stream(index) == \
        torch.cuda.current_stream(index).cuda_stream
    x = torch.randn((1024, 1024), device=cuda_device)
    g, b = torch.ones(1024, device=cuda_device), torch.zeros(
        1024, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert cuda_build._current_raw_stream(index) == side.cuda_stream
        got = layer_norm_rows(x, g, b)
    torch.cuda.current_stream().wait_stream(side)
    assert _err(got, layer_norm_rows_plain(x, g, b)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6e-2)])
def test_layer_norm_rows_kernel_matches_plain(cuda_device, dtype, tol):
    """The gated widths on their fixed-width kernel (PE's LayerNorm rows,
    Hiera-L's stage 4 at 1152, whose bf16 rows with bf16 scale / bias take
    half-warps: an odd row count leaves the last half-warp idle), the other
    widths on the generic one (a ViT-H-14 width with a leading shape, 768,
    2048, a narrow odd one), scale / bias in f32 and in bf16; bf16 also
    within ATTN_SHARE."""
    from ovo_tpu_torch.ops import cuda_build
    from ovo_tpu_torch.ops.layer_norm import (layer_norm_rows,
                                              layer_norm_rows_plain)

    rng = np.random.default_rng(32)
    for shape in ((4088, 1024), (1024, 1152), (1023, 1152), (3, 7, 1152),
                  (5, 1024), (7, 5, 1280), (9, 768), (33, 2048), (33, 68)):
        C = shape[-1]
        x = _dev(rng.standard_normal(shape), cuda_device, dtype)
        for affine in (torch.float32, torch.bfloat16):
            g = _dev(rng.random(C) + 0.5, cuda_device, affine)
            b = _dev(rng.standard_normal(C), cuda_device, affine)
            cuda_build.reset_launch_counts()
            got = layer_norm_rows(x, g, b)
            assert cuda_build.launch_counts()["layer_norm_rows"] == 1
            ref = layer_norm_rows_plain(x, g, b)
            assert got.shape == x.shape and got.dtype == x.dtype
            assert _err(got, ref) <= tol
            assert _shares_ok(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_packed_heads_kernel_matches_plain(cuda_device, dtype, tol):
    rng = np.random.default_rng(33)
    # (windows, lq, lk, heads, hd): Hiera-L's stage 1 and stage 3 windows,
    # a q-pooled transition (Lq < Lk), 16-wide heads
    for B, lq, lk, heads, hd in ((40, 64, 64, 2, 72), (3, 196, 196, 8, 72),
                                 (20, 16, 64, 4, 72), (9, 49, 49, 2, 16)):
        dout = heads * hd
        qkv = _dev(rng.standard_normal((B, lk, 3, dout)), cuda_device, dtype)
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        # q as the trunk gives it: a column slice, or pooled and contiguous
        q = qkv[:, :, 0] if lq == lk else _dev(
            rng.standard_normal((B, lq, dout)), cuda_device, dtype)
        got = A.packed_heads_attention(q, k, v, heads=heads)
        ref = A.packed_heads_attention_plain(q, k, v, heads=heads)
        assert got.shape == (B, lq, dout)
        assert _err(got, ref) <= tol
        assert _shares_ok(got, ref, dtype)
    # rows that are not 16-byte aligned take the narrow loads
    qu, ku, vu = (_unaligned(t) for t in (q, k, v))
    got = A.packed_heads_attention(qu, ku, vu, heads=heads)
    assert _err(got, A.packed_heads_attention_plain(q, k, v,
                                                    heads=heads)) <= tol


@pytest.mark.cuda
def test_mask_tail_kernel_matches_plain(cuda_device):
    """SAM2's widths (c1 64, c2 32): a ragged prompt group (11, 9: not a
    multiple of the 8 prompts a block), one prompt, row counts that are not
    a multiple of the 128-row block or the 16-row warp tile (60, 140), 1 to
    4 channels, and the AMG's 64 x 64 rows; the share of logits off by more
    than 2^-10 too."""
    from ovo_tpu_torch.ops import cuda_build
    from ovo_tpu_torch.ops import mask_tail as MT

    rng = np.random.default_rng(34)
    bf = torch.bfloat16
    c1, c2 = 64, 32
    # (prompts, H, W, channels)
    for B, H, W, C in ((11, 16, 16, 3), (3, 8, 4, 4), (1, 3, 5, 1),
                       (9, 5, 7, 2), (4, 64, 64, 3)):
        R = H * W * 4
        up1g = _dev(rng.standard_normal((B, R, c1)), cuda_device, bf)
        w2q = _dev(rng.standard_normal((4, c1, c2)) * 0.1, cuda_device, bf)
        b2 = _dev(rng.standard_normal(c2) * 0.1, cuda_device, bf)
        hr0q = _dev(rng.standard_normal((4, R, c2)), cuda_device, bf)
        hyper = _dev(rng.standard_normal((B, C, c2)), cuda_device, bf)
        args = (up1g, w2q, b2, hr0q, hyper)
        cuda_build.reset_launch_counts()
        got = MT.fused_mask_tail(*args, H=H, W=W)
        assert cuda_build.launch_counts()["mask_tail"] == 1
        assert got.shape == (B, 4, R, C) and got.dtype == torch.float32
        ref = MT.fused_mask_tail_plain(*args)
        assert _err(got, ref) <= 0.125
        assert _mismatch_share(got, ref) <= 1e-3
    with pytest.raises(ValueError, match="bf16"):
        MT.fused_mask_tail(up1g.float(), w2q, b2, hr0q, hyper, H=H, W=W)


@pytest.mark.cuda
def test_device_ms_times_an_untraced_call_by_events(cuda_device,
                                                    monkeypatch):
    """chip_smoke.device_ms: a call none of whose traces holds the card's
    events is timed by CUDA events over calls back to back (run_ms, which
    includes host gaps, so at least the traced time) and listed in
    UNTRACED with no kernel names; later calls trace again."""
    import chip_smoke
    import torch.profiler

    class EmptyTrace:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return []

    monkeypatch.setattr(chip_smoke, "UNTRACED", [])
    a = torch.randn(4096, 4096, device=cuda_device, dtype=torch.bfloat16)
    traced = chip_smoke.device_ms(lambda: a @ a, tag="traced")
    parts = {}
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "profile", EmptyTrace)
        untraced = chip_smoke.device_ms(lambda: a @ a, by_name=parts,
                                        tag="untraced")
    again = chip_smoke.device_ms(lambda: a @ a, tag="again")
    assert chip_smoke.UNTRACED == ["untraced"] and parts == {}
    assert 0.8 * traced < untraced < 3 * traced
    assert 0.5 * traced < again < 2 * traced
