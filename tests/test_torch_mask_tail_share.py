"""The share statistic that chip_smoke.py and the card tests hold kernel B13
(fused_mask_tail) to, beside its 0.125 max-abs limit: the share of logits
that differ from the plain version by more than 2^-10, at most
``chip_smoke.B13_SHARE``; and the bf16 arithmetic its tensor-core design
rests on.

The kernel sums each tap's product over c1 = 64 as one mma.sync chain
from zero: four steps of 16 products, each step's sum added to the
accumulator without rounding to nearest. On the CPU, at SAM2's widths
(c1 64, c2 32, 3 channels) over a few thousand rows, that chain, modelled
with each step rounded to nearest and toward zero, moves about 1e-4 of the
logits (a product on a bf16 rounding edge flips a gelu output a step),
10x under the limit; the decoder's unfused tail (its gelu computed in f32
and rounded once) breaks it.

The kernel's epilogue runs the gelu chain on bf16 pairs (``mul.rn`` /
``add.rn.bf16x2``, each rounded once from the exact result). For two bf16
operands that is what the reference computes, an f32 op then a bf16
rounding: shown here on the CPU over many operand pairs, and shown not to
hold for a fused multiply-add, which the kernel therefore does not use.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from ovo_tpu_torch.ops import mask_tail as MT

BF = torch.bfloat16
H, W, C1, C2, C = 16, 32, 64, 32, 3


def _t(rng, *shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(
        np.float32)).to(BF)


@pytest.fixture(scope="module")
def tail_inputs():
    """check_b13's scales at fewer prompts and rows: N(0,1) activations,
    skip and hypernet, taps and bias of 0.1; hr0 as the raster skip."""
    rng = np.random.default_rng(130)
    B = 6
    up1g, hr0, hyper = (_t(rng, B, H * W * 4, C1), _t(rng, 4 * H, 4 * W, C2),
                        _t(rng, B, C, C2))
    w2q, b2 = _t(rng, 4, C1, C2, std=0.1), _t(rng, C2, std=0.1)
    return up1g, w2q, b2, hr0, hyper


def _toward_zero(t):
    """f64 t rounded to f32 toward zero."""
    r = t.float()
    return torch.where(r.double().abs() > t.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _chain(a, b, truncate):
    """a @ b in f32 as one mma chain from zero sums it: 16 products at a
    time, each block's exact sum added to the accumulator and the result
    rounded to f32, to nearest or (``truncate``) toward zero."""
    acc = None
    for k0 in range(0, a.shape[-1], 16):
        blk = a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16, :].double()
        s = blk if acc is None else acc.double() + blk
        acc = _toward_zero(s) if truncate else s.float()
    return acc


def _mma_tail(up1g, w2q, b2, hr0q, hyper, truncate):
    """B13 as its tensor-core kernel computes it: each tap's y over c1 as
    one chain, rounded to bf16; + b2, + hr0q and the gelu in bf16; the
    hypernet dot over c2 as one more chain."""
    hyp_t = hyper.float().transpose(1, 2)
    taps = []
    for t in range(4):
        y = _chain(up1g.float(), w2q[t].float(), truncate).to(BF)
        g = MT.gelu_tanh_bf16(y + b2 + hr0q[t])
        taps.append(_chain(g.float(), hyp_t, truncate))
    return torch.stack(taps, dim=1)


@pytest.mark.parametrize("truncate", [False, True])
def test_mma_chain_stays_under_the_share(tail_inputs, truncate):
    """The kernel's mma chains (one over c1 from zero) stay 4x under
    B13_SHARE and inside the max-abs limit (a CPU run: 6.5e-5 to 1.0e-4
    of the logits over 12288 rows)."""
    up1g, w2q, b2, hr0, hyper = tail_inputs
    hr0q = MT.gather_hr0q(hr0, H, W)
    ref = MT.fused_mask_tail_plain(up1g, w2q, b2, hr0q, hyper)
    got = _mma_tail(up1g, w2q, b2, hr0q, hyper, truncate)
    assert float((got - ref).abs().max()) <= 0.125
    assert chip_smoke._mismatch_share(got, ref) <= chip_smoke.B13_SHARE / 4


def test_mma_chain_is_not_the_plain_sum(tail_inputs):
    """The modelled chain does move logits (the test above is not vacuous)
    and the truncated chain differs from the one rounded to nearest."""
    up1g, w2q, b2, hr0, hyper = tail_inputs
    hr0q = MT.gather_hr0q(hr0, H, W)
    ref = MT.fused_mask_tail_plain(up1g, w2q, b2, hr0q, hyper)
    near, trunc = (_mma_tail(up1g, w2q, b2, hr0q, hyper, t)
                   for t in (False, True))
    assert chip_smoke._mismatch_share(trunc, ref) > 0
    assert not torch.equal(near, trunc)


def test_unfused_tail_breaks_the_share(tail_inputs):
    """check_b13's yardstick, the decoder's unfused tail (upscale2, skip,
    F.gelu on bf16, which computes in f32 and rounds once), is another
    function: it breaks B13_SHARE though the max-abs limit passes it."""
    up1g, w2q, b2, hr0, hyper = tail_inputs
    hr0q = MT.gather_hr0q(hr0, H, W)
    ref = MT.mask_tail_to_raster(
        MT.fused_mask_tail_plain(up1g, w2q, b2, hr0q, hyper), H, W)
    unfused = chip_smoke._unfused_tail(up1g, w2q, b2, hr0, hyper, H, W)
    assert float((unfused - ref).abs().max()) <= 0.125
    assert chip_smoke._mismatch_share(unfused, ref) > chip_smoke.B13_SHARE


def _bf16_values(rng, n, spread):
    """n bf16 values of random sign and mantissa, exponents within
    +-spread (as f64)."""
    m = rng.integers(128, 256, n) / 128.0
    e = rng.integers(-spread, spread + 1, n)
    return np.where(rng.random(n) < 0.5, -1.0, 1.0) * np.ldexp(m, e)


def _round_bf16(x):
    """f64 values rounded once to bf16, to nearest even (normal range)."""
    bits = x.view(np.uint64)
    lsb = (bits >> np.uint64(45)) & np.uint64(1)
    rounded = (bits + np.uint64((1 << 44) - 1) + lsb) >> np.uint64(45)
    return (rounded << np.uint64(45)).view(np.float64)


def _f32_then_bf16(x):
    return torch.from_numpy(x.astype(np.float32)).to(BF).double().numpy()


@pytest.mark.parametrize("spread", [3, 12, 40])
def test_bf16_pair_ops_round_as_f32_then_bf16(spread):
    """A sum or a product of two bf16 values rounded once to bf16 (the
    kernel's add.rn / mul.rn.bf16x2) equals the reference's f32 op then bf16
    rounding: a product of two 8-bit significands is exact in f32, and a
    sum is either exact in f32 (exponents within 16 of each other) or so
    lopsided that both roundings give the larger operand."""
    rng = np.random.default_rng(spread)
    n = 400_000
    a, b = _bf16_values(rng, n, spread), _bf16_values(rng, n, spread)
    # operands exactly one step apart and equal with opposite signs too
    b[:1000] = -a[:1000]
    b[1000:2000] = a[1000:2000] * (1 + 2.0 ** -7)
    assert np.array_equal(_round_bf16(a + b), _f32_then_bf16(a + b))
    assert np.array_equal(_round_bf16(a * b), _f32_then_bf16(a * b))


def test_fused_multiply_add_rounds_otherwise():
    """bf16(a * b + c) rounded once (an hfma2) is not the reference's
    bf16(bf16(a * b) + c) for many operands: the kernel keeps the product
    and the sum apart."""
    rng = np.random.default_rng(7)
    n = 100_000
    a, b, c = (_bf16_values(rng, n, 3) for _ in range(3))
    fused = _round_bf16(a * b + c)
    twice = _round_bf16(_round_bf16(a * b) + c)
    assert np.mean(fused != twice) > 0.01
