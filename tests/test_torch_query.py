"""Open-vocabulary query and classification through both packages: the
online pipeline on the synthetic wall scene with ``ovo_tpu``'s OVOSemMap and
``ovo_tpu_torch``'s, the same JAX random weights carried into the port, then
``query`` and ``classify_instances`` on each map.

Two embedders: the crop ``hovsg`` embedder on a SigLIP-structured card
(sigmoid similarity, bidirectional text tower pooled at the last token), and
TextRegion on ``tiny-pe`` (cosine similarity, causal text tower). The maps
must be equal, similarities within 1e-5 and the classes equal wherever the
top-2 margin is above 1e-5 (a smaller margin may flip on rounding).
"""
import copy

import jax
import numpy as np
import pytest

from ovo_tpu.data.masks import CallableMaskSource as JaxMasks
from ovo_tpu.mapping.pipeline import OVOSemMap as JaxOVOSemMap
from ovo_tpu.models import clip as jclip
from ovo_tpu.models.textregion import TextRegionEmbedder as JaxTextRegion

from ovo_tpu_torch.data.masks import CallableMaskSource
from ovo_tpu_torch.mapping.pipeline import OVOSemMap
from ovo_tpu_torch.models import clip as tclip
from ovo_tpu_torch.models.textregion import TextRegionEmbedder

from synthetic_scene import SyntheticWallDataset, synthetic_mask_fn
from test_torch_crops import siglip_models
from test_torch_pipeline_e2e import make_config

CLASSES = ["wall", "chair", "table", "door", "window", "floor", "lamp"]
TEMPLATES = ["This is a photo of a {}", "a {} in a room"]


def run_both(tmp_path, jax_embedder, torch_embedder, clip_dim):
    cfg = make_config(clip_dim)
    j = JaxOVOSemMap(copy.deepcopy(cfg), tmp_path / "jax",
                     mask_source=JaxMasks(synthetic_mask_fn, max_masks=16),
                     embedder=jax_embedder,
                     dataset=SyntheticWallDataset(n_frames=8))
    j.run()
    t = OVOSemMap(copy.deepcopy(cfg), tmp_path / "torch",
                  mask_source=CallableMaskSource(synthetic_mask_fn,
                                                 max_masks=16, device="cpu"),
                  embedder=torch_embedder,
                  dataset=SyntheticWallDataset(n_frames=8), device="cpu")
    t.run()
    np.testing.assert_array_equal(t.ovo.active_ids(), j.ovo.active_ids())
    assert len(t.ovo.active_ids()) >= 3
    return j.ovo, t.ovo


def assert_same_answers(jovo, tovo):
    sim_j = np.asarray(jovo.query(CLASSES, TEMPLATES))
    sim_t = tovo.query(CLASSES, TEMPLATES)
    assert sim_t.shape == sim_j.shape == (len(tovo.active_ids()),
                                          len(CLASSES))
    np.testing.assert_allclose(sim_t, sim_j, atol=1e-5)
    rj = jovo.classify_instances(CLASSES)
    rt = tovo.classify_instances(CLASSES)
    np.testing.assert_array_equal(rt["ids"], rj["ids"])
    sims = np.asarray(jovo.query(CLASSES, ["This is a photo of a {}"]))
    top2 = np.sort(sims, axis=1)
    clear = top2[:, -1] - top2[:, -2] > 1e-5
    assert clear.sum() >= 2
    np.testing.assert_array_equal(rt["classes"][clear],
                                  np.asarray(rj["classes"])[clear])
    np.testing.assert_allclose(rt["conf"], rj["conf"], atol=1e-5)
    # a threshold above every similarity leaves every instance unclassified
    high = tovo.classify_instances(CLASSES, th=float(sim_t.max()) + 1.0)
    assert (high["classes"] == -1).all() and (high["conf"] == 0).all()


def test_query_crop_hovsg_siglip_structured(tmp_path):
    jm, tm = siglip_models(64, 16, seed=3, logit_bias=0.0)
    jovo, tovo = run_both(
        tmp_path, jclip.CropCLIPEmbedder(jm, "hovsg", mask_res=48),
        tclip.CropCLIPEmbedder(tm, "hovsg", mask_res=48), 32)
    assert_same_answers(jovo, tovo)
    sims = tovo.query(CLASSES)
    assert ((sims > 0) & (sims < 1)).all()           # sigmoid similarity


def test_query_textregion_tiny_pe(tmp_path):
    jm = jclip.CLIPModel.random_init("tiny-pe")
    tm = tclip.CLIPModel.from_jax_params(
        "tiny-pe", jax.tree_util.tree_map(np.asarray, jm.params),
        device="cpu")
    jovo, tovo = run_both(tmp_path, JaxTextRegion(jm),
                          TextRegionEmbedder(tm), 32)
    assert_same_answers(jovo, tovo)


def test_query_needs_instances():
    from ovo_tpu_torch.mapping.semantic import SemanticMapper

    tm = tclip.CLIPModel.random_init("tiny-test", device="cpu")
    ovo = SemanticMapper(make_config(32)["semantic"],
                         cam_intrinsics=np.eye(3, dtype=np.float32),
                         embedder=tclip.CropCLIPEmbedder(tm), device="cpu")
    with pytest.raises(ValueError, match="No 3D instances"):
        ovo.query(["chair"])
