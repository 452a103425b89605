"""Kernels B5 (rope_packed_attention) and B6 (masked_pool) of the PyTorch
port: their plain versions against the JAX package's Pallas kernels run in
interpret mode on the CPU, at 2e-5 abs in f32 (same math, different
summation order), and in bf16 at the limits the card holds the kernels to
(``chip_smoke.py``): B5 max abs 1e-2 and at most ``ATTN_SHARE`` of the
outputs off by more than one bf16 step (both sides round the rotated q / k
and the normalized weights, so a value on a rounding edge may flip), B6
max abs 4e-3 (the weights stay f32 on both sides; one rounding of the
output). The CUDA kernels are held against these plain versions in
``tests/test_torch_cuda_kernels.py``, which runs on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ovo_tpu.models.layers import rope2d_freqs as jax_rope2d_freqs
from ovo_tpu.ops.attention import rope_packed_attention as jax_rope_packed
from ovo_tpu.ops.masked_pool import pallas_masked_pool

from chip_smoke import ATTN_SHARE, step_share
from ovo_tpu_torch.models.layers import rope2d_freqs
from ovo_tpu_torch.ops import cuda_build
from ovo_tpu_torch.ops.attention import (rope_packed_attention,
                                         rope_packed_attention_plain)
from ovo_tpu_torch.ops.masked_pool import masked_pool, masked_pool_plain


def _rope_inputs(seed, B, H, hd, L, grid):
    rng = np.random.default_rng(seed)
    D = H * hd
    cos, sin = jax_rope2d_freqs(grid, grid, hd, n_prefix=1)
    cos, sin = np.array(cos[:L]), np.array(sin[:L])
    qkv = rng.standard_normal((B, L, 3 * D)).astype(np.float32)
    return qkv, cos, sin


@pytest.mark.parametrize("L,grid,kv_len", [(145, 12, None), (64, 8, None),
                                           (64, 8, 50)])
def test_rope_packed_plain_matches_pallas(L, grid, kv_len):
    B, H, hd = 2, 4, 32
    qkv, cos, sin = _rope_inputs(7, B, H, hd, L, grid)
    ref = np.asarray(jax_rope_packed(jnp.asarray(qkv), jnp.asarray(cos),
                                     jnp.asarray(sin), heads=H,
                                     kv_len=kv_len, interpret=True))
    got = rope_packed_attention(torch.from_numpy(qkv), torch.from_numpy(cos),
                                torch.from_numpy(sin), heads=H,
                                kv_len=kv_len).numpy()
    assert got.shape == (B, L, H * hd)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_rope_packed_plain_matches_pallas_bf16():
    """PE-Core's head size (64), keys past kv_len masked, L not a multiple
    of 8 (the Pallas wrapper pads it)."""
    B, H, hd, L, kv_len = 2, 2, 64, 145, 130
    qkv, cos, sin = _rope_inputs(8, B, H, hd, L, 12)
    ref = jax_rope_packed(jnp.asarray(qkv).astype(jnp.bfloat16),
                          jnp.asarray(cos), jnp.asarray(sin), heads=H,
                          kv_len=kv_len, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    got = rope_packed_attention(torch.from_numpy(qkv).to(torch.bfloat16),
                                torch.from_numpy(cos), torch.from_numpy(sin),
                                heads=H, kv_len=kv_len)
    assert got.dtype == torch.bfloat16 and got.shape == (B, L, H * hd)
    assert float((got.float() - ref).abs().max()) <= 1e-2
    assert step_share(got, ref) <= ATTN_SHARE


def test_rope_tables_match_jax():
    cos, sin = jax_rope2d_freqs(24, 24, 64, n_prefix=1)
    c, s = rope2d_freqs(24, 24, 64, n_prefix=1)
    np.testing.assert_allclose(c.numpy(), np.asarray(cos), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(sin), atol=1e-6)


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


@pytest.mark.parametrize("m,h,l,d", [(5, 4, 96, 32), (20, 2, 300, 16)])
def test_masked_pool_plain_matches_pallas(m, h, l, d):
    q, k, v, mask = _pool_inputs(3, m, h, l, d, full_masked_rows=(1,))
    ref = np.asarray(pallas_masked_pool(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        scale=d ** -0.5, interpret=True))
    got = masked_pool(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), torch.from_numpy(mask),
                      d ** -0.5).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # a fully masked row pools the uniform mean of v, finite
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1], v.mean(axis=1), atol=1e-5)


def test_masked_pool_plain_matches_pallas_bf16():
    """TextRegion's layout in bf16: one probe query per mask, k one row per
    head broadcast over the tokens (stride 0 on the port's side), a
    head-transposed v, and a fully masked row."""
    m, h, l, d = 12, 4, 300, 64
    q, k, v, mask = _pool_inputs(9, m, h, l, d, full_masked_rows=(2,))
    q = np.broadcast_to(q[:1], q.shape).copy()
    kb = np.broadcast_to(k[:, :1], k.shape)
    ref = pallas_masked_pool(
        jnp.asarray(q).astype(jnp.bfloat16),
        jnp.asarray(kb).astype(jnp.bfloat16),
        jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(mask),
        scale=d ** -0.5, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    bf = torch.bfloat16
    kt = torch.from_numpy(k[:, :1]).to(bf).expand(h, l, d)
    vt = torch.from_numpy(np.ascontiguousarray(v.transpose(1, 0, 2))).to(
        bf).transpose(0, 1)
    got = masked_pool(torch.from_numpy(q).to(bf), kt, vt,
                      torch.from_numpy(mask), d ** -0.5)
    assert got.dtype == bf
    assert np.abs(got.float().numpy() - ref).max() <= 4e-3
    uniform = vt.float().mean(dim=1).numpy()
    assert np.abs(got[2].float().numpy() - uniform).max() <= 4e-3


def test_masked_pool_accepts_strided_shared_keys():
    """TextRegion feeds a stride-0 broadcast k and a head-transposed v view;
    the wrapper consumes them without copies and agrees with dense
    inputs."""
    q, k, v, mask = _pool_inputs(5, 6, 4, 40, 16)
    kb = torch.from_numpy(k[:, :1]).expand(4, 40, 16)
    vt = torch.from_numpy(np.ascontiguousarray(v.transpose(1, 0, 2))
                          ).transpose(0, 1)
    got = masked_pool(torch.from_numpy(q), kb, vt, torch.from_numpy(mask),
                      0.25)
    ref = masked_pool_plain(torch.from_numpy(q), kb.contiguous(),
                            torch.from_numpy(v), torch.from_numpy(mask), 0.25)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


def test_cpu_wrappers_count_no_launch():
    cuda_build.reset_launch_counts()
    qkv, cos, sin = _rope_inputs(1, 1, 2, 16, 20, 5)
    rope_packed_attention(torch.from_numpy(qkv), torch.from_numpy(cos),
                          torch.from_numpy(sin), heads=2)
    assert cuda_build.launch_counts() == {name: 0
                                          for name in cuda_build.LAUNCH_NAMES}
    assert set(cuda_build.KERNELS) >= {"rope_packed_attention", "masked_pool"}
