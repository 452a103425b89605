"""Checkpoints on disk through both packages' factories, on the CPU: an
open_clip / PE checkpoint (``clip.ckpt_path``) through both
``build_clip_embedder``s gives the same embeddings (cosine 1 within 1e-6),
and a merger ``model.pt`` through both ``load_merger``s the same fused
descriptors (2e-4). The checkpoints are the JAX random weights laid out
under the official keys (``chip_smoke.official_state_dict``) and written
with ``torch.save``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models import clip as jclip
from ovo_tpu.models import merger as jmerger

import chip_smoke
from ovo_tpu_torch.models import clip as tclip
from ovo_tpu_torch.models import merger as tmerger


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _scene(h=96, w=128):
    rng = np.random.default_rng(3)
    image = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    masks = np.zeros((4, h, w), bool)
    masks[0, :40, :60] = True
    masks[1, 30:, 70:] = True
    masks[2, 10:70, 20:100] = rng.random((60, 80)) > 0.5
    return image, masks, masks.any(axis=(1, 2))


@pytest.mark.parametrize("card,embed_type", [("tiny-pe", "TextRegion"),
                                             ("tiny-test", "vanilla"),
                                             ("tiny-test", "hovsg")])
def test_clip_checkpoint_through_both_factories(tmp_path, card, embed_type):
    params = np_tree(jclip.CLIPModel.random_init(card, seed=5).params)
    # a wrapped, DataParallel-style checkpoint: both loaders unwrap it
    sd = {f"module.{k}": v for k, v in
          chip_smoke.official_state_dict("clip", params).items()}
    path = tmp_path / "open_clip_pytorch_model.bin"
    torch.save({"state_dict": sd}, path)
    cfg = {"model_card": card, "ckpt_path": str(path), "mask_res": 48}
    ours = tclip.build_clip_embedder(cfg, embed_type, device="cpu")
    theirs = jclip.build_clip_embedder(cfg, embed_type)
    image, masks, valid = _scene()
    got = ours.embed_masks(image, masks, valid).numpy()
    ref = np.asarray(theirs.embed_masks(image, masks, valid))
    rows = np.linalg.norm(ref, axis=-1) > 0
    assert got.shape == ref.shape and rows.sum() >= 3
    np.testing.assert_allclose(cosine(got[rows], ref[rows]), 1.0, atol=1e-6)
    texts = ["a chair", "a wall"]
    np.testing.assert_allclose(
        cosine(ours.embed_text(texts).numpy(),
               np.asarray(theirs.embed_text(texts))), 1.0, atol=1e-6)
    # the loaded weights are the tree's, not a random init's, and lie in
    # row-major memory as a random init's do (the converters hand over
    # transposed views)
    np.testing.assert_array_equal(
        ours.model.visual.blocks[0].attn.qkv.w.float().numpy(),
        params["visual"]["blocks"][0]["attn"]["qkv"]["w"])
    for module in (ours.model.visual, ours.model.text):
        assert all(p.is_contiguous() for p in module.parameters())


def test_merger_checkpoint_through_both_loaders(tmp_path):
    params = np_tree(jmerger.init_merger(jax.random.PRNGKey(4), d_model=64,
                                         depth=2))
    torch.save(chip_smoke.official_state_dict("merger", params),
               tmp_path / "model.pt")
    ours = tmerger.load_merger(str(tmp_path), device="cpu")
    theirs = jmerger.load_merger(str(tmp_path))
    assert len(ours.params.blocks) == 2
    assert all(p.is_contiguous() for p in ours.params.parameters())
    clips = np.random.default_rng(6).standard_normal((5, 3, 64)).astype(
        np.float32)
    clips /= np.linalg.norm(clips, axis=-1, keepdims=True)
    got = ours(torch.from_numpy(clips)).numpy()
    ref = np.asarray(theirs(jnp.asarray(clips)))
    np.testing.assert_allclose(got, ref, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)

