"""Kernels B14 (layer_norm_rows), B11 (packed_heads_attention) and B13
(fused_mask_tail) of the PyTorch port against the JAX package, on the CPU.

Each plain version against the reference's Pallas kernel run in interpret
mode, at the reference tests' own shapes and tolerances: B14 on the cases
of ``tests/test_attention_ops.py::test_pallas_layer_norm_matches_xla`` (f32
rtol 1e-6 / atol 1e-5, bf16 within one output step), B11 on those of
``test_packed_heads_attention_matches_composed`` (2e-5), B13 on
``tests/test_sam.py::test_fused_mask_tail_matches_xla``'s (2e-5 abs, 1e-5
rel: the plain version rounds the tanh-gelu op by op, as the interpreted
kernel does). Then the routes that reach them: the Hiera trunk with
``window_attn="packed"`` against the JAX trunk (f32, 2e-4), and
``decode_masks(mask_tail="fused")`` in bf16 against the JAX package's
decoder with its tail replaced by the interpreted ``fused_mask_tail``. The
CUDA kernels are held against these plain versions in
``tests/test_torch_cuda_kernels.py``, on the card.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models import layers as JL
from ovo_tpu.models.sam import decoder as jdec
from ovo_tpu.models.sam.hiera import HIERA_CONFIGS as JAX_HIERA
from ovo_tpu.models.sam.hiera import hiera_forward as jax_hiera_forward
from ovo_tpu.models.sam.hiera import init_hiera as jax_init_hiera
from ovo_tpu.models.sam.model import SAMModel as JaxSAM
from ovo_tpu.ops import attention as jatt
from ovo_tpu.ops import layer_norm as jln
from ovo_tpu.ops import mask_tail as jtail

from ovo_tpu_torch.models.convert_jax import load_jax_params
from ovo_tpu_torch.models.sam import decoder as tdec
from ovo_tpu_torch.models.sam import hiera as thiera
from ovo_tpu_torch.models.sam.model import SAMModel
from ovo_tpu_torch.models.sam.params import Init, ParamTree
from ovo_tpu_torch.ops import attention as A
from ovo_tpu_torch.ops import cuda_build
from ovo_tpu_torch.ops import layer_norm as tln
from ovo_tpu_torch.ops import mask_tail as ttail


def t(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bf16_t(x):
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# B14: layer_norm_rows
# ---------------------------------------------------------------------------

# the reference's cases (tests/test_attention_ops.py:220-248), the decoder's
# 2^20 rows cut to 4096 as the reference cuts them in interpret mode; its
# bf16 limit allows one output step (f32 reduction order in var)
@pytest.mark.parametrize("rows,c,dtype", [(4039, 1024, "bfloat16"),
                                          (4096, 256, "bfloat16"),
                                          (2048, 128, "float32")])
def test_layer_norm_rows_plain_matches_pallas(rows, c, dtype):
    rng = np.random.default_rng(rows + c)
    x = jnp.asarray(rng.standard_normal((rows, c)), dtype)
    scale = rng.standard_normal((c,)).astype(np.float32)
    bias = rng.standard_normal((c,)).astype(np.float32)
    ref = jln._ln_call(x, jnp.asarray(scale), jnp.asarray(bias), eps=1e-5,
                       interpret=True)
    xt = t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tln.layer_norm_rows(xt, t(scale), t(bias))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    bf = dtype == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=1e-2 if bf else 1e-6,
                               atol=3e-2 if bf else 1e-5)


# the gated widths (PE's 7 x 584 rows at C 1024, Hiera-L's stage 4 at 1152)
# through leading shapes, with scale / bias in bf16 as well as f32: the
# kernel reads a bf16 affine as it is, the Pallas kernel and the plain
# version widen it to f32 (exactly)
@pytest.mark.parametrize("shape,dtype,affine", [
    ((4, 256, 1152), "bfloat16", "bfloat16"),
    ((7, 584, 1024), "bfloat16", "bfloat16"),
    ((1024, 1152), "float32", "bfloat16"),
    ((2, 512, 1152), "bfloat16", "float32")])
def test_layer_norm_rows_gated_widths_match_pallas(shape, dtype, affine):
    c = shape[-1]
    rng = np.random.default_rng(c + len(shape))
    x = jnp.asarray(rng.standard_normal(shape), dtype)
    scale = jnp.asarray(rng.standard_normal((c,)) * 0.1 + 1.0, affine)
    bias = jnp.asarray(rng.standard_normal((c,)), affine)
    ref = jln._ln_call(x.reshape(-1, c), scale, bias, eps=1e-5,
                       interpret=True).reshape(shape)
    xt = t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    st, bt = (t(np.asarray(v.astype(jnp.float32))).to(getattr(torch, affine))
              for v in (scale, bias))
    got = tln.layer_norm_rows(xt, st, bt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    bf = dtype == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=1e-2 if bf else 1e-6,
                               atol=3e-2 if bf else 1e-5)


def test_layer_norm_rows_any_leading_shape_and_gate():
    """(7, 584, 1024) reads as 4088 rows; the shapes the port drives B14 at
    pass the reference's gate ``fits``, which refuses a C that is not a
    multiple of 128 and fewer than 1024 rows."""
    rng = np.random.default_rng(5)
    x = t(rng.standard_normal((7, 584, 64)).astype(np.float32))
    g, b = t(rng.standard_normal(64).astype(np.float32)), torch.zeros(64)
    np.testing.assert_array_equal(
        tln.layer_norm_rows(x, g, b).numpy(),
        tln.layer_norm_rows(x.reshape(-1, 64), g, b).reshape(x.shape).numpy())
    for rows, c, it in ((4088, 1024, 2), (1024, 1152, 2), (4088, 1024, 4),
                        (1024, 1280, 2)):
        assert tln.fits(rows, c, it) == jln.fits(rows, c, it) is True
    for rows, c in ((1023, 1024), (4096, 1000)):
        assert tln.fits(rows, c, 2) == jln.fits(rows, c, 2) is False
    cuda_build.reset_launch_counts()
    tln.layer_norm_rows(x, g, b)
    assert cuda_build.launch_counts()["layer_norm_rows"] == 0


@pytest.mark.parametrize("stream", [True, False])
def test_entry_sets_its_signature_without_loading(stream):
    """A cuda_build.Entry holds its C signature (the stream last, unless
    it takes none) and loads no library until it is first called: the
    wrappers' entries are made at import, where no kernel is built."""
    entry = cuda_build.Entry("residual_layer_norm", "ovo_layer_norm_rows",
                             [ctypes.c_void_p, ctypes.c_int], stream=stream)
    assert entry.argtypes == [ctypes.c_void_p, ctypes.c_int] + (
        [ctypes.c_void_p] if stream else [])
    assert entry._fn is None
    assert callable(cuda_build._current_device)
    assert callable(cuda_build._current_raw_stream)


# ---------------------------------------------------------------------------
# B11: packed_heads_attention
# ---------------------------------------------------------------------------

# the reference's shapes (tests/test_attention_ops.py:459-460): the q_pool
# case (Lq != Lk) and odd lengths, which the TPU kernel pads and masks
@pytest.mark.parametrize("B,lq,lk,heads,dout", [(12, 49, 49, 2, 144),
                                                (5, 36, 196, 8, 64),
                                                (9, 64, 64, 4, 288)])
def test_packed_heads_plain_matches_pallas(B, lq, lk, heads, dout):
    rng = np.random.default_rng(B * lq + lk)
    q, k, v = (rng.standard_normal((B, n, dout)).astype(np.float32)
               for n in (lq, lk, lk))
    ref = jatt.packed_heads_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), heads=heads,
                                      interpret=True)
    got = A.packed_heads_attention(t(q), t(k), t(v), heads=heads)
    assert got.shape == (B, lq, dout)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_packed_heads_reads_qkv_column_slices():
    """k and v as the trunk hands them over (column slices of one packed
    (B, L, 3 * dout) projection, row stride 3 * dout) give what contiguous
    copies give; the gate is the reference's less its TPU terms."""
    rng = np.random.default_rng(7)
    qkv = t(rng.standard_normal((4, 49, 3, 144)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = A.packed_heads_attention(q, k, v, heads=2)
    ref = A.packed_heads_attention_plain(q.contiguous(), k.contiguous(),
                                         v.contiguous(), heads=2)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert A.use_packed_heads(64, 64, 144, 2) and A.use_packed_heads(
        49, 196, 1152, 16)
    assert not A.use_packed_heads(4096, 4096, 576, 8)      # global blocks
    assert not A.use_packed_heads(64, 64, 96, 8)           # hd 12


@pytest.mark.parametrize("size", [128, 256])
def test_hiera_packed_route_matches_jax(size):
    """The trunk with ``window_attn="packed"``: every window block through
    B11's plain version, the global block as before; f32 features within
    2e-4 of the JAX trunk, and bit-equal to the port's default route (the
    plain versions compute one function)."""
    cfg = JAX_HIERA["hiera_test"]
    jp = jax_init_hiera(jax.random.PRNGKey(3), cfg)
    tcfg = thiera.HIERA_CONFIGS["hiera_test"]
    tp = load_jax_params(ParamTree(thiera.init_hiera(Init(None, "cpu"),
                                                     tcfg)), np_tree(jp))
    imgs = np.random.default_rng(size + 1).standard_normal(
        (1, size, size, 3)).astype(np.float32)
    ref = jax_hiera_forward(jp, cfg, jnp.asarray(imgs))
    calls = []
    orig = thiera.packed_heads_attention
    thiera.packed_heads_attention = lambda *a, **k: (calls.append(1)
                                                     or orig(*a, **k))
    try:
        packed = thiera.hiera_forward(tp, tcfg, t(imgs), window_attn="packed")
    finally:
        thiera.packed_heads_attention = orig
    heads = thiera.hiera_forward(tp, tcfg, t(imgs))
    n_window = sum(ws > 0 for *_, ws, _ in tcfg.block_layout())
    assert len(calls) == n_window == 4
    for o, h, r in zip(packed, heads, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-4)
        np.testing.assert_array_equal(o.numpy(), h.numpy())
    with pytest.raises(ValueError):
        thiera.hiera_forward(tp, tcfg, t(imgs), window_attn="windows")


# ---------------------------------------------------------------------------
# B13: fused_mask_tail
# ---------------------------------------------------------------------------

def _tail_inputs(seed, B=3, H=16, W=16, c1=32, c2=16, C=3):
    """tests/test_sam.py:294-300's inputs and their kernel layout."""
    rng = np.random.default_rng(seed)
    bf = jnp.bfloat16
    up = jnp.asarray(rng.standard_normal((B, H, W, 2, 2, c1)), bf)
    w2 = jnp.asarray(rng.standard_normal((2, 2, c1, c2)) * 0.1, bf)
    b2 = jnp.asarray(rng.standard_normal((c2,)) * 0.1, bf)
    hr0 = jnp.asarray(rng.standard_normal((4 * H, 4 * W, c2)), bf)
    hyper = jnp.asarray(rng.standard_normal((B, C, c2)), bf)
    hr0q = hr0.reshape(H, 2, 2, W, 2, 2, c2).transpose(
        2, 5, 0, 3, 1, 4, 6).reshape(4, H * W * 4, c2)
    return (up.reshape(B, H * W * 4, c1), w2.reshape(4, c1, c2), b2, hr0q,
            hyper, hr0)


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_tail_plain_matches_pallas(seed):
    H = W = 16
    up1g, w2q, b2, hr0q, hyper, hr0 = _tail_inputs(seed)
    ref = jtail.mask_tail_to_raster(jtail.fused_mask_tail(
        up1g, w2q, b2, hr0q, hyper, H=H, W=W, interpret=True), H, W)
    args = [bf16_t(a) for a in (up1g, w2q, b2, hr0q, hyper)]
    got4 = ttail.fused_mask_tail(*args, H=H, W=W)
    assert got4.dtype == torch.float32 and got4.shape == (3, 4, H * W * 4, 3)
    got = ttail.mask_tail_to_raster(got4, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)
    # the port's gather of the raster skip is the reference's
    np.testing.assert_array_equal(
        ttail.gather_hr0q(bf16_t(hr0), H, W).float().numpy(),
        np.asarray(hr0q.astype(jnp.float32)))


def test_mask_tail_gelu_rounds_op_by_op():
    """The tail's gelu is JAX's bf16 tanh-gelu bit for bit; the one-rounding
    ``F.gelu`` is not (that gap is why the plain version spells it out)."""
    x = jnp.asarray(np.random.default_rng(2).standard_normal(4096) * 3,
                    jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda v: jax.nn.gelu(v, approximate=True))(
        x).astype(jnp.float32))
    got = ttail.gelu_tanh_bf16(bf16_t(x)).float().numpy()
    np.testing.assert_array_equal(got, ref)
    one = torch.nn.functional.gelu(bf16_t(x), approximate="tanh")
    assert (one.float().numpy() != ref).any()


def test_mask_tail_mismatch_share_tells_gelus_apart(monkeypatch):
    """The card checks of B13 (chip_smoke.py, the card test) bound the share
    of logits off by more than 2^-10 to 1e-3, beside the 0.125 max-abs
    limit. At SAM2's widths, summing the c1 product in another order stays
    under the share; a gelu rounded once stays under 0.125 but not under
    the share."""
    torch.manual_seed(0)
    bf = torch.bfloat16
    B, R, c1, c2, C = 4, 1024, 64, 32, 3
    up1g = torch.randn(B, R, c1).to(bf)
    w2q = (torch.randn(4, c1, c2) * 0.1).to(bf)
    b2 = (torch.randn(c2) * 0.1).to(bf)
    hr0q, hyper = torch.randn(4, R, c2).to(bf), torch.randn(B, C, c2).to(bf)
    ref = ttail.fused_mask_tail_plain(up1g, w2q, b2, hr0q, hyper)

    def share(got):
        return float(((got - ref).abs() > 2 ** -10).float().mean())

    reordered = ttail.fused_mask_tail_plain(up1g.flip(-1), w2q.flip(1), b2,
                                            hr0q, hyper)
    assert share(reordered) <= 1e-3
    monkeypatch.setattr(ttail, "gelu_tanh_bf16", lambda x: torch.nn.functional
                        .gelu(x, approximate="tanh"))
    once = ttail.fused_mask_tail_plain(up1g, w2q, b2, hr0q, hyper)
    assert float((once - ref).abs().max()) <= 0.125
    assert share(once) > 0.5


@pytest.fixture(scope="module")
def bf16_decoders():
    jm = JaxSAM.random_init("hiera_test", image_size=256, seed=5)
    tm = SAMModel.from_jax_params("hiera_test", 256, np_tree(jm.params),
                                  device="cpu")
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
        jm.params["decoder"])
    return jp, tm.params["decoder"]


def _jax_decode_fused_tail(jp, embed, pe, sparse, hr, chans):
    """The JAX package's decode_masks with its tail replaced by the
    interpreted Pallas kernel (tests/test_sam.py:311-316's layout)."""
    H, W, d = embed.shape
    B = sparse.shape[0]
    prefix = jnp.concatenate([jp["obj_score_token"][None],
                              jp["iou_token"][None], jp["mask_tokens"]],
                             axis=0).astype(embed.dtype)
    tokens = jnp.concatenate([jnp.broadcast_to(prefix, (B, 6, d)),
                              sparse.astype(embed.dtype)], axis=1)
    queries, keys = jdec.two_way_transformer(
        jp, tokens, embed.reshape(1, H * W, d),
        pe.reshape(1, H * W, d).astype(embed.dtype), 8)
    mask_tokens = queries[:, 2:6]
    up = jdec._up_blocked(jp["upscale1"], keys.reshape(B, H, W, d))
    up = up + hr[1].reshape(H, 2, W, 2, -1).transpose(0, 2, 1, 3, 4)[None]
    up = JL.gelu(JL.layer_norm(jp["upscale_ln"], up))
    hyper = jnp.stack([jdec._mlp3(jp["hyper_mlps"][i], mask_tokens[:, i])
                       for i in chans], axis=1)
    c1, c2 = up.shape[-1], jp["upscale2"]["w"].shape[-1]
    hr0q = hr[0].reshape(H, 2, 2, W, 2, 2, c2).transpose(
        2, 5, 0, 3, 1, 4, 6).reshape(4, H * W * 4, c2)
    m4 = jtail.fused_mask_tail(
        up.reshape(B, H * W * 4, c1), jp["upscale2"]["w"].reshape(4, c1, c2),
        jp["upscale2"]["b"], hr0q, hyper, H=H, W=W, interpret=True)
    return jtail.mask_tail_to_raster(m4, H, W)


def test_decode_masks_fused_tail_matches_jax(bf16_decoders):
    """bf16, a (16, 16, 256) embedding and 6 prompts on the unfused route
    (the reference's XLA algebra): the port's decode with
    ``mask_tail="fused"`` against the JAX decoder whose tail is the
    interpreted kernel. The two-way transformers round their bf16
    intermediates in other places (two layers of one-step flips), so the
    logits agree to 5% of the largest; the tail itself is held exactly
    above. ``"fused"`` and ``"unfused"`` differ by the gelu's rounding
    (about one bf16 step of its output times |hyper|)."""
    jp, tp = bf16_decoders
    rng = np.random.default_rng(62)
    bf = jnp.bfloat16
    embed, pe = (jnp.asarray(rng.standard_normal((16, 16, 256)), bf)
                 for _ in range(2))
    sparse = jnp.asarray(rng.standard_normal((6, 2, 256)), bf)
    hr = [jnp.asarray(rng.standard_normal((64, 64, 32)), bf),
          jnp.asarray(rng.standard_normal((32, 32, 64)), bf)]
    chans = (1, 2, 3)
    ref = np.asarray(_jax_decode_fused_tail(jp, embed, pe, sparse, hr,
                                            chans))
    calls = []
    orig = tdec.fused_mask_tail
    tdec.fused_mask_tail = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        kw = dict(high_res_feats=[bf16_t(h) for h in hr], mask_channels=chans,
                  route="unfused")
        got = tdec.decode_masks(tp, bf16_t(embed), bf16_t(pe), bf16_t(sparse),
                                mask_tail="fused", **kw)["masks"]
    finally:
        tdec.fused_mask_tail = orig
    unfused = tdec.decode_masks(tp, bf16_t(embed), bf16_t(pe),
                                bf16_t(sparse), **kw)["masks"]
    assert len(calls) == 1 and got.shape == (6, 3, 64, 64)
    scale = float(np.abs(ref).max())
    assert np.isfinite(got.numpy()).all() and scale > 1.0
    np.testing.assert_allclose(got.numpy(), ref, atol=0.05 * scale)
    assert float((got - unfused).abs().max()) <= 0.05 * scale


def test_decode_masks_fused_tail_refuses_f32(bf16_decoders):
    _, tp = bf16_decoders
    embed = torch.zeros((4, 4, 256))
    hr = [torch.zeros((16, 16, 32)), torch.zeros((8, 8, 64))]
    with pytest.raises(ValueError, match="bf16"):
        tdec.decode_masks(tp, embed, embed, torch.zeros((2, 1, 256)),
                          high_res_feats=hr, mask_tail="fused")
    with pytest.raises(ValueError):
        tdec.decode_masks(tp, embed, embed, torch.zeros((2, 1, 256)),
                          high_res_feats=hr, mask_tail="raster")
