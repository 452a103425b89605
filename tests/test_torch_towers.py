"""PE tower and TextRegion of the PyTorch port against the JAX package on
the ``tiny-pe`` card, with the JAX random weights carried across by
``ovo_tpu_torch.models.convert_jax``.

Tolerances (PARITY.md section 1): f32 layers and towers 2e-4 abs;
TextRegion descriptors (unit vectors) cosine 1 +- 1e-6; bf16 primitives
one bf16 step (2^-7 relative) since XLA may fuse away the per-op rounding
that PyTorch keeps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models import layers as jL
from ovo_tpu.models import vit as jvit
from ovo_tpu.models.clip import CLIPModel as JaxCLIP
from ovo_tpu.models.textregion import TextRegionEmbedder as JaxTextRegion
from ovo_tpu.models.textregion import _remove_global_patch as jax_rgp

from ovo_tpu_torch.models import layers as L
from ovo_tpu_torch.models import vit as tvit
from ovo_tpu_torch.models.clip import CLIPModel
from ovo_tpu_torch.models.convert_jax import flatten_tree, load_jax_params
from ovo_tpu_torch.models.textregion import TextRegionEmbedder
from ovo_tpu_torch.models.textregion import _remove_global_patch

ATOL = 2e-4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jm = JaxCLIP.random_init("tiny-pe")
    tm = CLIPModel.from_jax_params("tiny-pe", np_tree(jm.params),
                                   device="cpu")
    return jm, tm


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_linear_layer_norm_mlp(rng):
    p = jL.init_block(jax.random.PRNGKey(1), 32, 4)
    p["ln1"]["scale"] = jnp.asarray(rng.random(32) + 0.5, jnp.float32)
    p["ln1"]["bias"] = jnp.asarray(rng.standard_normal(32), jnp.float32)
    blk = load_jax_params(L.Block(32, 4), np_tree(p))
    x = rng.standard_normal((2, 7, 32)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(
        blk.attn.qkv(t(x)).numpy(),
        np.asarray(jL.linear(p["attn"]["qkv"], jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(
        blk.ln1(t(x)).numpy(),
        np.asarray(jL.layer_norm(p["ln1"], jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(
        L.mlp(blk.mlp, t(x)).numpy(),
        np.asarray(jL.mlp(p["mlp"], jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_dtype_rule(rng, dtype):
    """erf gelu in f32, tanh gelu in bf16 -- on both sides."""
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ours = L.gelu(t(np.asarray(jx.astype(jnp.float32)),
                    getattr(torch, dtype))).float().numpy()
    ref = np.asarray(jL.gelu(jx).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, atol=1e-6)
    else:
        np.testing.assert_allclose(ours, ref, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(rng, dtype):
    cos, sin = jL.rope2d_freqs(5, 5, 16, n_prefix=1)
    x = rng.standard_normal((2, 4, 26, 16)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = np.asarray(jL.apply_rope(jx, cos, sin).astype(jnp.float32))
    ours = L.apply_rope(t(np.asarray(jx.astype(jnp.float32)),
                          getattr(torch, dtype)), t(cos), t(sin))
    tol = 1e-6 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_transformer_block_with_rope(rng, impl):
    p = jL.init_block(jax.random.PRNGKey(2), 64, 4)
    blk = load_jax_params(L.Block(64, 4), np_tree(p))
    cos, sin = jL.rope2d_freqs(6, 6, 16, n_prefix=1)
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    ref = np.asarray(jL.transformer_block(p, jnp.asarray(x), 4,
                                          rope=(cos, sin), attn_impl="xla"))
    ours = L.transformer_block(blk, t(x), 4, rope=(t(cos), t(sin)),
                               attn_impl=impl)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("causal", [False, True])
def test_transformer_block_without_rope(rng, monkeypatch, impl, causal):
    """``attn_impl="xla"`` takes the composed plain path and never the
    kernel routes of ``dot_product_attention``; both match JAX's XLA
    route."""
    p = jL.init_block(jax.random.PRNGKey(3), 64, 4)
    blk = load_jax_params(L.Block(64, 4), np_tree(p))
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    ref = np.asarray(jL.transformer_block(p, jnp.asarray(x), 4,
                                          causal=causal, attn_impl="xla"))
    if impl == "xla":
        def kernel_route(*a, **k):
            raise AssertionError("attn_impl='xla' reached a kernel route")
        monkeypatch.setattr(L, "dot_product_attention", kernel_route)
    ours = L.transformer_block(blk, t(x), 4, causal=causal, attn_impl=impl)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("with_rope,impl,error", [
    (True, "auto", ValueError),            # B5's wrapper: CPU or CUDA only
    (True, "xla", NotImplementedError),
    (False, "auto", ValueError),           # no RoPE: B2's wrapper (L 37)
    (False, "xla", NotImplementedError),   # the plain route is CPU only
])
def test_plain_attention_takes_cpu_tensors_only(with_rope, impl, error):
    """Off the CPU, attention launches a kernel (B5 with RoPE, B10 / B2 /
    B1 without) or raises: a tensor that is not on the CPU never reaches the
    composed plain path."""
    blk = L.Block(64, 4, device="meta")
    cos, sin = L.rope2d_freqs(6, 6, 16, n_prefix=1, device="meta")
    x = torch.zeros((2, 37, 64), device="meta")
    with pytest.raises(error):
        L.multi_head_attention(blk.attn, x, 4,
                               rope=(cos, sin) if with_rope else None,
                               attn_impl=impl)


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

def test_converted_params_cover_the_tree(models):
    jm, tm = models
    names = {n for n, _ in tm.visual.named_parameters()}
    assert names == {k for k, _ in flatten_tree(np_tree(jm.params["visual"]))}


@pytest.mark.parametrize("size", [64, 96])
def test_forward_features_matches_jax(models, rng, size):
    """64: the trained grid; 96: off-grid (bilinear pos interp + 6x6 RoPE
    tables)."""
    jm, tm = models
    imgs = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jvit.forward_features(jm.params["visual"],
                                           jm.cfg.vision, jnp.asarray(imgs)))
    ours = tvit.forward_features(tm.visual, tm.cfg.vision, t(imgs)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_encode_matches_jax(models, rng):
    jm, tm = models
    imgs = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jvit.encode(jm.params["visual"], jm.cfg.vision,
                                 jnp.asarray(imgs)))
    ours = tvit.encode(tm.visual, tm.cfg.vision, t(imgs)).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def _masks(h, w):
    masks = np.zeros((4, h, w), bool)
    masks[0, :50, :70] = True
    masks[1, 40:, 90:] = True
    masks[2, 20:80, 40:120] = True          # slot 3 stays empty (padding)
    return masks


@pytest.mark.parametrize("remove_global", [False, True])
@pytest.mark.parametrize("hw", [(96, 160), (140, 200)])
def test_textregion_matches_jax(models, rng, remove_global, hw):
    """Multi-resolution (1x2 and 2x3 crop grids + the global view, H and W
    >= 2x the crop), soft masks, optional global-patch removal, probe pool
    (kernel B6's plain version) and projection; an empty padding slot
    included."""
    jm, tm = models
    h, w = hw
    image = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    masks = _masks(h, w)
    valid = np.ones(4, bool)
    ref = np.asarray(JaxTextRegion(
        jm, remove_global_patch=remove_global).embed_masks(image, masks,
                                                           valid))
    ours = TextRegionEmbedder(tm, remove_global_patch=remove_global
                              ).embed_masks(image, masks, valid).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=5e-4)
    np.testing.assert_allclose((ours * ref).sum(-1), 1.0, atol=1e-6)


def test_remove_global_patch_matches_jax(rng):
    x = rng.standard_normal((32, 16)).astype(np.float32)
    fm = (rng.random((4, 32)) > 0.4).astype(np.float32)
    for th in (0.07, 0.9):
        ref = np.asarray(jax_rgp(jnp.asarray(x), jnp.asarray(fm), th))
        ours = _remove_global_patch(t(x), t(fm), th).numpy()
        np.testing.assert_array_equal(ours, ref)
