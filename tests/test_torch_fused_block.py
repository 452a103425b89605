"""Kernels B12a / B12b (the whole-block tower path) of the PyTorch port
against the JAX package: the plain versions against the interpreted Pallas
``fused_attn_block`` / ``fused_mlp_block`` on the cases of
``tests/test_fused_block.py``, the fused tiny-pe tower against JAX's fused
tower, and the routing rules. Weights come across with
``convert_jax.load_jax_params``.

Tolerances: f32 blocks 2e-5 (the JAX tests' own limit: sums in another
order); the f32 fused tower 3e-5 (the same, through three blocks); bf16 one
bf16 step of each output plus 2^-7 absolute (both sides round the same
intermediates, but a value on a rounding edge may fall either way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models import layers as jL
from ovo_tpu.models import vit as jvit
from ovo_tpu.models.clip import CLIPModel as JaxCLIP
from ovo_tpu.ops import fused_block as jfb

from ovo_tpu_torch.models import layers as L
from ovo_tpu_torch.models import vit as tvit
from ovo_tpu_torch.models.clip import CLIPModel
from ovo_tpu_torch.models.convert_jax import load_jax_params
from ovo_tpu_torch.ops import fused_block as tfb

D, HEADS, LP = 256, 4, 128


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def block_params(seed, rng, hidden_ratio=4.0):
    """A JAX block with random biases and LayerNorm affines (init_block
    leaves them at 0 / 1, which would hide a bias or order mistake)."""
    p = jL.init_block(jax.random.PRNGKey(seed), D, HEADS, mlp_ratio=hidden_ratio)
    p = np_tree(p)
    for name in ("ln1", "ln2"):
        p[name]["scale"] = (rng.random(D) + 0.5).astype(np.float32)
        p[name]["bias"] = (rng.standard_normal(D) * 0.1).astype(np.float32)
    for lin in (p["attn"]["qkv"], p["attn"]["out"], p["mlp"]["fc"],
                p["mlp"]["proj"]):
        lin["b"] = (rng.standard_normal(lin["w"].shape[1]) * 0.1).astype(
            np.float32)
    return p


def port_block(p, dtype=torch.float32):
    hidden = p["mlp"]["fc"]["w"].shape[1]
    return load_jax_params(L.Block(D, HEADS, hidden / D, dtype=dtype), p)


@pytest.mark.parametrize("causal,rope", [(False, False), (False, True),
                                         (True, False)])
def test_fused_block_matches_jax_kernels(rng, causal, rope):
    """Both halves through ``fused_transformer_block`` on a padded slab
    (the last 21 keys masked) against the interpreted Pallas kernels."""
    p = block_params(0, rng)
    x = rng.standard_normal((2, LP, D)).astype(np.float32)
    rope_t = jL.rope2d_freqs(8, 16, D // HEADS) if rope else None
    l_real = LP - 21
    ref = jfb.fused_transformer_block(p, jnp.asarray(x), HEADS, rope=rope_t,
                                      causal=causal, l_real=l_real,
                                      interpret=True)
    rope_p = tuple(t(a) for a in rope_t) if rope else None
    got = tfb.fused_transformer_block(port_block(p), t(x), HEADS, rope=rope_p,
                                      causal=causal, l_real=l_real)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_fused_attn_half_and_arrangement(rng):
    """B12a alone: the port's per-head arrangement equals JAX's, and the
    attention half matches with RoPE on."""
    p = block_params(3, rng)
    blk = port_block(p)
    w, b, ow, ob = tfb._arrange_attn_weights(blk, HEADS)
    jw, jb, jow, job = jfb._arrange_attn_weights(p, HEADS)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb)[:, 0])
    np.testing.assert_array_equal(ow.numpy(), np.asarray(jow))
    cos, sin = jL.rope2d_freqs(8, 16, D // HEADS)
    x = rng.standard_normal((LP, D)).astype(np.float32)
    ref = jfb.fused_attn_block(
        jnp.asarray(x), jw, jb, jow, job, p["ln1"]["scale"], p["ln1"]["bias"],
        cos, sin, n_heads=HEADS, L_real=LP - 5, causal=False, use_rope=True,
        interpret=True)
    got = tfb.fused_attn_block(
        t(x)[None], w, b, ow, ob, blk.ln1.scale, blk.ln1.bias, t(cos),
        t(sin), n_heads=HEADS, L_real=LP - 5, causal=False, use_rope=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_mlp_half_matches_jax(rng, act):
    """B12b alone, hidden 1024 in two chunks of 512 (the tower's chunk)."""
    p = block_params(1, rng)
    m = p["mlp"]
    x = rng.standard_normal((LP, D)).astype(np.float32)
    ref = jfb.fused_mlp_block(jnp.asarray(x), m["fc"]["w"], m["fc"]["b"],
                              m["proj"]["w"], m["proj"]["b"],
                              p["ln2"]["scale"], p["ln2"]["bias"], act=act,
                              chunk=512, interpret=True)
    got = tfb.fused_mlp_block(t(x)[None], t(m["fc"]["w"]), t(m["fc"]["b"]),
                              t(m["proj"]["w"]), t(m["proj"]["b"]),
                              t(p["ln2"]["scale"]), t(p["ln2"]["bias"]),
                              act=act, chunk=512)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_fused_block_bf16_matches_jax(rng):
    """bf16 with RoPE: biases made bf16-representable, since the port keeps
    linear biases in the compute dtype where JAX's fused path adds the f32
    ones."""
    p = block_params(2, rng)
    for lin in (p["attn"]["qkv"], p["attn"]["out"], p["mlp"]["fc"],
                p["mlp"]["proj"]):
        lin["b"] = t(lin["b"], torch.bfloat16).float().numpy()
    x = rng.standard_normal((1, LP, D)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    rope_t = jL.rope2d_freqs(8, 16, D // HEADS)
    ref = np.asarray(jfb.fused_transformer_block(
        p, xb, HEADS, rope=rope_t, l_real=LP - 3,
        interpret=True).astype(jnp.float32))
    got = tfb.fused_transformer_block(
        port_block(p, torch.bfloat16),
        t(np.asarray(xb.astype(jnp.float32)), torch.bfloat16), HEADS,
        rope=tuple(t(a) for a in rope_t), l_real=LP - 3).float().numpy()
    # one bf16 step of each output (2^-7 relative) plus 2^-7 absolute for
    # the intermediates (LN, q, k, v, p, heads, hidden) that round the other
    # way on an edge; measured: 7.7% of the elements differ, by at most
    # 0.031 at |out| ~ 5 and 3.4e-3 near 0
    assert (np.abs(got - ref) <= 2.0 ** -7 * (np.abs(ref) + 1.0)).all()
    assert (got != ref).mean() < 0.2


def test_forward_features_fused_matches_jax(rng):
    """The tiny-pe tower through the fused path (no pad in the port, JAX
    pads 17 tokens to 128) against JAX's fused path: 3e-5."""
    jm = JaxCLIP.random_init("tiny-pe")
    tm = CLIPModel.from_jax_params("tiny-pe", np_tree(jm.params),
                                   device="cpu")
    cfg = jm.cfg.vision
    imgs = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jvit.forward_features(jm.params["visual"], cfg, jnp.asarray(imgs),
                                attn_impl="fused_block")
    got = tvit.forward_features(tm.visual, tm.cfg.vision, t(imgs),
                                attn_impl="fused_block")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=3e-5)
    # and the fused tower agrees with the per-layer kernel route
    base = tvit.forward_features(tm.visual, tm.cfg.vision, t(imgs))
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=2e-4)


def test_routing_rules(rng, monkeypatch):
    """LayerScale blocks fall back to the per-layer path; OVO_FUSED_BLOCK=1
    is ignored under "auto" for CPU tokens; an explicit "fused_block" takes
    the fused path on the CPU."""
    calls = []
    real = tfb.fused_transformer_block

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tfb, "fused_transformer_block", spy)
    tm = CLIPModel.random_init("tiny-pe", device="cpu")
    imgs = t(rng.standard_normal((1, 64, 64, 3)).astype(np.float32))
    vis, cfg = tm.visual, tm.cfg.vision
    monkeypatch.setenv("OVO_FUSED_BLOCK", "1")
    base = tvit.forward_features(vis, cfg, imgs)
    assert calls == [] and not tvit._use_fused_blocks("auto", vis,
                                                      torch.device("cpu"))
    assert tvit._use_fused_blocks("auto", vis, torch.device("cuda"))
    monkeypatch.delenv("OVO_FUSED_BLOCK")
    assert not tvit._use_fused_blocks("auto", vis, torch.device("cuda"))
    fused = tvit.forward_features(vis, cfg, imgs, attn_impl="fused_block")
    assert len(calls) == cfg.depth
    np.testing.assert_allclose(fused.numpy(), base.numpy(), atol=2e-4)

    ls_cfg = tvit.ViTConfig(image_size=64, patch_size=16, width=64, depth=2,
                            n_heads=4, embed_dim=32, layer_scale=0.1)
    ls = tvit.init_vit(ls_cfg, torch.Generator().manual_seed(0))
    calls.clear()
    a = tvit.forward_features(ls, ls_cfg, imgs, attn_impl="fused_block")
    b = tvit.forward_features(ls, ls_cfg, imgs)
    assert calls == []
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_hidden_chunk_must_divide(rng):
    """SigLIP-384's MLP (hidden 4304) does not split into chunks of 512:
    both packages refuse it."""
    x = rng.standard_normal((8, 16)).astype(np.float32)
    fc = rng.standard_normal((16, 4304)).astype(np.float32)
    proj = rng.standard_normal((4304, 16)).astype(np.float32)
    z16, z = np.zeros(16, np.float32), np.zeros(4304, np.float32)
    with pytest.raises(ValueError, match="must divide"):
        jfb.fused_mlp_block(jnp.asarray(x), fc, z, proj, z16, z16 + 1, z16,
                            chunk=512, interpret=True)
    with pytest.raises(ValueError, match="must divide"):
        tfb.fused_mlp_block(t(x)[None], t(fc), t(z), t(proj), t(z16),
                            t(z16 + 1), t(z16), chunk=512)


def test_arranged_weights_cache_follows_the_weights(rng):
    """The per-head arrangement is cached on the block and rebuilt when a
    weight is written in place or replaced."""
    blk = port_block(block_params(4, rng))
    first = tfb._arranged(blk, HEADS)
    assert tfb._arranged(blk, HEADS) is first
    with torch.no_grad():
        blk.attn.qkv.w.mul_(2.0)
    second = tfb._arranged(blk, HEADS)
    assert second is not first
    np.testing.assert_array_equal(second[0].numpy(), 2.0 * first[0].numpy())
