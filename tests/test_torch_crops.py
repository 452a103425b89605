"""The multi-crop descriptor of the PyTorch port against the JAX package:
``scale_and_translate`` and ``roi_crops`` (1e-5 abs on [0, 1] images), the
fusion rules (1e-6), the learned merger (2e-4, PARITY.md section 1), the
SigLIP MAP head (2e-4) and ``CropCLIPEmbedder`` end to end for every
``embed_type`` (cosine 1 - 1e-5), on a SigLIP-structured card at test scale
(no class token, attention pooling; 224^2 / 14 gives 256 tokens, so the
tower's attention takes kernel B10's route)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models import clip as jclip
from ovo_tpu.models import merger as jmerger
from ovo_tpu.models import text as jtext
from ovo_tpu.models import vit as jvit
from ovo_tpu.ops.similarity import fuse_clips as jax_fuse

from ovo_tpu_torch.models import clip as tclip
from ovo_tpu_torch.models import merger as tmerger
from ovo_tpu_torch.models import vit as tvit
from ovo_tpu_torch.models.convert_jax import merger_from_jax_params
from ovo_tpu_torch.ops.resize import scale_and_translate
from ovo_tpu_torch.ops.similarity import fuse_clips

EMBED_TYPES = ("vanilla", "fixed_weights", "adaptive_weights", "hovsg",
               "concept_fusion", "learned")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def siglip_card(image_size, patch_size, width=64, clip_dim=32):
    """A SigLIP-structured card at test scale, in both packages."""
    jcfg = jclip.CLIPModelConfig(
        name="tiny-siglip",
        vision=jvit.ViTConfig(image_size=image_size, patch_size=patch_size,
                              width=width, depth=2, n_heads=4,
                              mlp_ratio=3.7362, embed_dim=clip_dim,
                              use_cls_token=False, use_abs_pos=True,
                              pool="attn"),
        text=jtext.TextConfig(vocab_size=1024, context_length=64,
                              width=width, depth=2, n_heads=4,
                              mlp_ratio=3.7362, embed_dim=clip_dim,
                              causal=False, pool="last"),
        mean=jclip.SIGLIP_MEAN, std=jclip.SIGLIP_STD, siglip=True,
        clip_dim=clip_dim)
    tcfg = tclip.CLIPModelConfig(
        name="tiny-siglip",
        vision=tvit.ViTConfig(**{k: v for k, v in dataclasses.asdict(
            jcfg.vision).items() if k != "dtype"}),
        text=tclip.TextConfig(**{k: v for k, v in dataclasses.asdict(
            jcfg.text).items() if k != "dtype"}),
        mean=tclip.SIGLIP_MEAN, std=tclip.SIGLIP_STD, siglip=True,
        clip_dim=clip_dim)
    return jcfg, tcfg


def siglip_models(image_size, patch_size, seed=0, map_head=True,
                  logit_bias=-10.0):
    jcfg, tcfg = siglip_card(image_size, patch_size)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"visual": jvit.init_vit(k1, jcfg.vision),
              "text": jtext.init_text(k2, jcfg.text),
              "logit_scale": jnp.asarray(np.log(10.0), jnp.float32),
              "logit_bias": jnp.asarray(logit_bias, jnp.float32)}
    if map_head:
        # timm's AttentionPoolLatent MLP, as converted SigLIP params carry
        w = jcfg.vision.width
        ka, kb = jax.random.split(k3)
        params["visual"]["attn_pool"]["ln2"] = {
            "scale": jnp.full((w,), 1.1), "bias": jnp.full((w,), 0.05)}
        params["visual"]["attn_pool"]["mlp"] = {
            "fc": jclip.vit_mod.L.init_linear(ka, w, 4 * w),
            "proj": jclip.vit_mod.L.init_linear(kb, 4 * w, w)}
    jm = jclip.CLIPModel(jcfg, params)
    tm = tclip.CLIPModel.from_jax_params(tcfg, np_tree(params), device="cpu")
    return jm, tm


# ---------------------------------------------------------------------------
# crops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out", [(24, 40), (90, 70)])
def test_scale_and_translate_matches_jax(rng, out):
    """Down- and upscaling, fractional shifts, windows reaching past the
    image (zero weight outside it)."""
    x = rng.random((3, 37, 53, 3)).astype(np.float32)
    scale = np.array([[0.6, 1.3], [2.5, 0.45], [1.0, 1.0]], np.float32)
    trans = np.array([[-3.2, 4.1], [-40.0, -2.0], [10.5, -20.25]],
                     np.float32)
    ref = np.stack([np.asarray(jax.image.scale_and_translate(
        jnp.asarray(x[i]), out + (3,), (0, 1), jnp.asarray(scale[i]),
        jnp.asarray(trans[i]), method="bilinear")) for i in range(3)])
    got = scale_and_translate(torch.from_numpy(x), out,
                              torch.from_numpy(scale),
                              torch.from_numpy(trans)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    shared = scale_and_translate(torch.from_numpy(x[0]), out,
                                 torch.from_numpy(scale),
                                 torch.from_numpy(trans)).numpy()
    np.testing.assert_allclose(shared[0], got[0], atol=1e-6)


def test_roi_crops_match_jax(rng):
    """An empty mask (bbox (0, 0, 1, 1)), masks touching the image border,
    and a bbox larger than the 336 output (downscaled with antialias)."""
    h, w = 420, 520
    image = rng.random((h, w, 3)).astype(np.float32)
    masks = np.zeros((5, h, w), bool)
    masks[1, 0:30, 480:] = True                     # top-right corner
    masks[2, 10:415, 5:500] = rng.random((405, 495)) > 0.3   # > 336 px
    masks[3, 200:201, 0:1] = True                   # one pixel, left edge
    masks[4, 300:, 100:180] = True                  # bottom edge
    seg_j, bbox_j = jclip.roi_crops(jnp.asarray(image), jnp.asarray(masks),
                                    out_size=336)
    seg, bbox = tclip.roi_crops(torch.from_numpy(image),
                                torch.from_numpy(masks), out_size=336)
    assert seg.shape == bbox.shape == (5, 336, 336, 3)
    np.testing.assert_allclose(seg.numpy(), np.asarray(seg_j), atol=1e-5)
    np.testing.assert_allclose(bbox.numpy(), np.asarray(bbox_j), atol=1e-5)
    # the padded square leaves a black border around a thin mask
    assert float(seg[4, :, :20].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# fusion and the merger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("embed_type", EMBED_TYPES[:-1])
def test_fuse_clips_matches_jax(rng, embed_type):
    """Unit inputs plus two padded (zero) mask slots: hovsg and
    concept_fusion softmax over the mask axis, padded slots included."""
    g, s, b = (rng.standard_normal((1 if i == 0 else 9, 24)).astype(
        np.float32) for i in range(3))
    g = np.repeat(g, 9, axis=0)
    s[-2:] = 0.0
    unit = [x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
            for x in (g, s, b)]
    ref = np.asarray(jax_fuse(*map(jnp.asarray, unit), embed_type, 0.4418,
                              0.1))
    got = fuse_clips(*map(torch.from_numpy, unit), embed_type, 0.4418, 0.1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_merger_matches_jax(rng):
    """Head size 144 (1152 / 8): the plain attention route."""
    params = jmerger.init_merger(jax.random.PRNGKey(5), d_model=1152,
                                 depth=2)
    clips = rng.standard_normal((6, 3, 1152)).astype(np.float32)
    clips /= np.linalg.norm(clips, axis=-1, keepdims=True)
    ref = np.asarray(jmerger.merger_apply(params, jnp.asarray(clips)))
    ours = merger_from_jax_params(np_tree(params), "cpu")(
        torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-5)


def test_load_merger_random_or_refuses_checkpoint(tmp_path):
    """No model.pt: seeded random weights. A model.pt is loaded
    (tests/test_torch_checkpoints.py); an empty one is refused by
    torch.load."""
    m = tmerger.load_merger(None, device="cpu")
    out = m(torch.nn.functional.normalize(torch.randn(4, 3, 1152), dim=-1))
    assert out.shape == (4, 1152) and torch.isfinite(out).all()
    (tmp_path / "model.pt").write_bytes(b"")
    with pytest.raises(EOFError):
        tmerger.load_merger(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# the image tower's MAP head and the crop embedder end to end
# ---------------------------------------------------------------------------

def test_map_head_encode_matches_jax(rng):
    jm, tm = siglip_models(64, 16)
    assert tm.visual.attn_pool.mlp is not None
    imgs = rng.random((3, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jm.encode_image(jnp.asarray(imgs)))
    ours = tm.encode_image(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def _scene(rng, h=120, w=160):
    image = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    masks = np.zeros((5, h, w), bool)
    masks[0, :50, :70] = True
    masks[1, 40:, 90:] = True
    masks[2, 20:80, 40:120] = rng.random((60, 80)) > 0.5
    masks[3, 100:, :10] = True                  # slot 4 stays empty
    return image, masks, masks.any(axis=(1, 2))


@pytest.mark.parametrize("embed_type,size,patch", [
    *((et, 64, 16) for et in EMBED_TYPES),
    ("hovsg", 224, 14), ("learned", 224, 14)])
def test_crop_embedder_matches_jax(rng, embed_type, size, patch):
    jm, tm = siglip_models(size, patch, seed=size)
    jmer = tmer = None
    if embed_type == "learned":
        mp = jmerger.init_merger(jax.random.PRNGKey(9), d_model=32, depth=2)
        jmer = jmerger.LearnedMerger(mp)
        tmer = merger_from_jax_params(np_tree(mp), "cpu")
    image, masks, valid = _scene(rng)
    res = size * 3 // 4
    ref = np.asarray(jclip.CropCLIPEmbedder(
        jm, embed_type, mask_res=res, merger=jmer).embed_masks(
            image, masks, valid))
    ours = tclip.CropCLIPEmbedder(tm, embed_type, mask_res=res,
                                  merger=tmer).embed_masks(
        image, masks, valid).numpy()
    assert ours.shape == (5, 32) and np.isfinite(ours).all()
    cos = (ours * ref).sum(-1) / (np.linalg.norm(ours, axis=-1)
                                  * np.linalg.norm(ref, axis=-1))
    np.testing.assert_allclose(cos, 1.0, atol=1e-5)


def test_factory_builds_every_embed_type(tmp_path):
    from ovo_tpu_torch.factory import build_embedder
    from ovo_tpu_torch.models.textregion import TextRegionEmbedder

    for et in EMBED_TYPES:
        emb = build_embedder({"clip": {"embed_type": et,
                                       "model_card": "tiny-test",
                                       "mask_res": 48}}, device="cpu")
        assert isinstance(emb, tclip.CropCLIPEmbedder)
        assert emb.embed_type == et and emb.mask_res == 48
        assert (emb.merger is not None) == (et == "learned")
    tr = build_embedder({"clip": {"embed_type": "TextRegion",
                                  "model_card": "tiny-pe"}}, device="cpu")
    assert isinstance(tr, TextRegionEmbedder)
    ckpt = tmp_path / "open_clip.bin"   # a present checkpoint is loaded:
    ckpt.write_bytes(b"")                # an empty one is refused
    with pytest.raises(EOFError):
        build_embedder({"clip": {"embed_type": "hovsg",
                                 "model_card": "tiny-test",
                                 "ckpt_path": str(ckpt)}}, device="cpu")
