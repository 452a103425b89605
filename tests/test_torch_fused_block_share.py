"""The share statistic that chip_smoke.py and the card tests hold kernels
B12a (fused_attn_block) and B12b (fused_mlp_block) to in bf16, beside their
max-abs limit: the share of outputs that differ from the plain version by
more than one bf16 step at the plain output's magnitude, at most
``chip_smoke.B12_SHARE``.

On the CPU, at a reduced width (2 views of 150 tokens, D 128, 2 heads of
64, hidden 512): the right function with its f32 sums taken as the
kernels' mma chains take them stays under the limit, and each wrong
function that chip_smoke.py's B12 checks name breaks it, though the
max-abs limit (6e-2) passes them: B12b with h left in f32 or its bf16 gelu
computed with erf, B12a with q and k rounded before the f32 RoPE or its
weights left unrounded. The chain is modelled two ways: each mma's sum of
16 products rounded to nearest (another order of the same sums), and
rounded toward zero, the way the mma accumulates without rounding to
nearest, with the kernels' k groups (each from zero, joined by one f32
add; B12a's qkv GEMM in groups of one 64-deep k step). The routes the
kernels take are read on the card (tests/test_torch_cuda_kernels.py).
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from ovo_tpu_torch.models.layers import rope2d_freqs
from ovo_tpu_torch.ops import fused_block as FB

BF = torch.bfloat16
B, L, D, HEADS, HIDDEN = 2, 150, 128, 2, 512


def _t(rng, *shape, std=1.0, mean=0.0, dtype=BF):
    return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(
        np.float32)).to(dtype)


def _weights(rng):
    hd = D // HEADS
    f32 = torch.float32
    return dict(w=_t(rng, HEADS, D, 3 * hd, std=D ** -0.5),
                b=_t(rng, HEADS, 3 * hd, std=0.1, dtype=f32),
                ow=_t(rng, HEADS, hd, D, std=D ** -0.5),
                ob=_t(rng, D, std=0.1, dtype=f32),
                ls=_t(rng, D, std=0.1, mean=1.0, dtype=f32),
                lb=_t(rng, D, std=0.1, dtype=f32),
                fc=_t(rng, D, HIDDEN, std=D ** -0.5),
                fcb=_t(rng, HIDDEN, std=0.1, dtype=f32),
                pw=_t(rng, HIDDEN, D, std=HIDDEN ** -0.5),
                pb=_t(rng, D, std=0.1, dtype=f32))


def _toward_zero(t):
    """f64 t rounded to f32 toward zero."""
    r = t.float()
    return torch.where(r.double().abs() > t.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _chain(a, b, *, truncate, group=None):
    """a @ b in f32 with the k axis summed as an mma chain sums it: 16
    products at a time, each block's exact sum added to the accumulator and
    the result rounded to f32, to nearest or (``truncate``) toward zero;
    in groups of ``group`` k (default: one group), each from zero
    accumulators, joined to the running sum by one f32 add."""
    K = a.shape[-1]
    group = group or K
    acc = None
    for g0 in range(0, K, group):
        part = None
        for k0 in range(g0, min(g0 + group, K), 16):
            blk = a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16, :].double()
            s = blk if part is None else part.double() + blk
            part = _toward_zero(s) if truncate else s.float()
        acc = part if acc is None else acc + part
    return acc


CHAINS = {"nearest": dict(truncate=False), "toward_zero": dict(truncate=True)}


def _mlp(x, fc_w, fc_b, proj_w, proj_b, ls, lb, *, act, chunk, mm):
    """fused_mlp_block_plain's op order with its products through mm."""
    dt = x.dtype
    lnx = FB._ln_rows(x, ls, lb).float()
    acc = torch.zeros(x.shape, dtype=torch.float32)
    for c0 in range(0, fc_w.shape[1], chunk):
        h = mm(lnx, fc_w[:, c0:c0 + chunk].float()) + fc_b[c0:c0 + chunk]
        h = FB._act(h, act, dt).to(dt)
        acc = acc + mm(h.float(), proj_w[c0:c0 + chunk].float())
    return (x.float() + acc + proj_b).to(dt)


def _attn(x, w_heads, b_heads, ow_heads, out_b, ls, lb, cos, sin, *, n_heads,
          L_real, causal, use_rope, mm, qkv_mm=None):
    """fused_attn_block_plain's op order with its products through mm (the
    qkv product through ``qkv_mm`` where given)."""
    dt = x.dtype
    n = x.shape[-2]
    hd = w_heads.shape[-1] // 3
    lnx = FB._ln_rows(x, ls, lb).float()
    col = torch.arange(n)
    mask = (col >= L_real)[None, :]
    if causal:
        mask = mask | (col[None, :] > col[:, None])
    acc = torch.zeros(x.shape, dtype=torch.float32)
    for h in range(n_heads):
        qkv = (qkv_mm or mm)(lnx, w_heads[h].float()) + b_heads[h]
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        if use_rope:
            q, k = FB._rot(q, cos, sin), FB._rot(k, cos, sin)
        s = mm(q.to(dt).float(), k.to(dt).float().transpose(-1, -2)) \
            * hd ** -0.5
        s = torch.where(mask, torch.full_like(s, -1e30), s)
        p = torch.softmax(s, dim=-1).to(dt)
        oh = mm(p.float(), v.to(dt).float()).to(dt)
        acc = acc + mm(oh.float(), ow_heads[h].float())
    return (x.float() + acc + out_b).to(dt)


@pytest.fixture(scope="module")
def mlp_case():
    rng = np.random.default_rng(120)
    p = _weights(rng)
    x = _t(rng, B, L, D)
    return (x, p["fc"], p["fcb"], p["pw"], p["pb"], p["ls"], p["lb"]), dict(
        act="gelu", chunk=256)


# B12a's cases: RoPE on every key; causal without RoPE, keys past 131
# masked
ATTN_CASES = {"rope": (L, False), "masked_causal": (131, True)}


@functools.lru_cache(maxsize=None)
def _attn_inputs(case):
    l_real, causal = ATTN_CASES[case]
    rng = np.random.default_rng(121)
    p = _weights(rng)
    x = _t(rng, B, L, D)
    cos, sin = rope2d_freqs(12, 12, D // HEADS, n_prefix=6)
    return (x, p["w"], p["b"], p["ow"], p["ob"], p["ls"], p["lb"], cos,
            sin), dict(n_heads=HEADS, L_real=l_real, causal=causal,
                       use_rope=not causal)


@pytest.fixture(params=sorted(ATTN_CASES))
def attn_case(request):
    return _attn_inputs(request.param)


def test_mlp_reimplementation_is_the_plain_version(mlp_case):
    args, kw = mlp_case
    assert torch.equal(_mlp(*args, **kw, mm=torch.matmul),
                       FB.fused_mlp_block_plain(*args, **kw))


def test_attn_reimplementation_is_the_plain_version(attn_case):
    args, kw = attn_case
    assert torch.equal(_attn(*args, **kw, mm=torch.matmul),
                       FB.fused_attn_block_plain(*args, **kw))


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_mlp_share_passes_another_sum_order(mlp_case, chain):
    args, kw = mlp_case
    ref = FB.fused_mlp_block_plain(*args, **kw)
    got = _mlp(*args, **kw, mm=functools.partial(_chain, **CHAINS[chain]))
    assert not torch.equal(got, ref)  # the order moved some outputs
    assert chip_smoke.step_share(got, ref) <= chip_smoke.B12_SHARE


@pytest.mark.parametrize("wrong", ["h_f32", "erf_gelu"])
def test_mlp_share_tells_wrong_functions_apart(mlp_case, wrong):
    args, kw = mlp_case
    ref = FB.fused_mlp_block_plain(*args, **kw)
    bad = chip_smoke.fused_mlp_block_variant(*args, **kw, **{wrong: True})
    # the max-abs limit alone passes it
    assert float((bad.float() - ref.float()).abs().max()) <= 6e-2
    assert chip_smoke.step_share(bad, ref) > chip_smoke.B12_SHARE


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_attn_share_passes_another_sum_order(attn_case, chain):
    args, kw = attn_case
    ref = FB.fused_attn_block_plain(*args, **kw)
    mm = functools.partial(_chain, **CHAINS[chain])
    got = _attn(*args, **kw, mm=mm, qkv_mm=functools.partial(mm, group=64))
    assert not torch.equal(got, ref)
    assert chip_smoke.step_share(got, ref) <= chip_smoke.B12_SHARE


def test_toward_zero_chain_is_not_the_nearest_one(mlp_case):
    """The truncating model moves sums the nearest one does not, and
    further from the exact sum."""
    args, _ = mlp_case
    a, b = args[0].float().reshape(-1, D), args[1].float()
    exact = a.double() @ b.double()
    near = _chain(a, b, truncate=False)
    trunc = _chain(a, b, truncate=True)
    assert not torch.equal(near, trunc)
    assert float((trunc - exact).abs().mean()) > \
        float((near - exact).abs().mean())


# q and k rounded early is another function only where RoPE runs
@pytest.mark.parametrize("case,wrong", [("rope", "qk_early"),
                                        ("rope", "p_f32"),
                                        ("masked_causal", "p_f32")])
def test_attn_share_tells_wrong_functions_apart(case, wrong):
    args, kw = _attn_inputs(case)
    ref = FB.fused_attn_block_plain(*args, **kw)
    bad = chip_smoke.fused_attn_block_variant(*args, **kw, **{wrong: True})
    assert float((bad.float() - ref.float()).abs().max()) <= 6e-2
    assert chip_smoke.step_share(bad, ref) > chip_smoke.B12_SHARE


def test_wrong_functions_are_the_plain_version_when_off(mlp_case, attn_case):
    args, kw = mlp_case
    assert torch.equal(chip_smoke.fused_mlp_block_variant(*args, **kw),
                       FB.fused_mlp_block_plain(*args, **kw))
    args, kw = attn_case
    assert torch.equal(chip_smoke.fused_attn_block_variant(*args, **kw),
                       FB.fused_attn_block_plain(*args, **kw))
