"""The share statistic that chip_smoke.py and the card tests hold kernels
B1 (flash_attention), B2 (windowed_fused_attention) and B11
(packed_heads_attention) to in bf16, beside their 1e-2 max-abs limit: the
share of outputs that differ from the plain version by more than one bf16
step at the plain output's magnitude, at most ``ATTN_SHARE``.

On the CPU, at the main paths' head sizes and key counts: a reordered f32
sum of the right function (keys permuted), and B1's p_hi + p_lo split of
its f32 weights (the kernel's p . v), stay under the limit; the functions
the kernels must not compute break it. Those are B1 with its weights
rounded once to bf16 (which the max-abs limit alone passes), and B2 / B11
with exp(s - m) rounded before it is normalized.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from ovo_tpu_torch.ops import attention as A

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
