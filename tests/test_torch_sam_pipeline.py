"""The online pipeline end to end through both packages with the LIVE mask
source: SAM2 automatic masks on the ``hiera_test`` card (f32, gates at 0 as
random weights need) and TextRegion on ``tiny-pe``, the JAX random weights
of both carried into the port. On the synthetic wall scene the point map,
the instance ids and the active set must be equal, and the descriptors
within cosine 1 +- 1e-6. Random weights give near-uniform logits, so each
keyframe keeps one whole-frame mask after the NMS stages (both packages).
"""
import copy

import jax
import numpy as np

from ovo_tpu.mapping.pipeline import OVOSemMap as JaxOVOSemMap
from ovo_tpu.models.clip import CLIPModel as JaxCLIP
from ovo_tpu.models.sam.amg import AutomaticMaskSource as JaxAMG
from ovo_tpu.models.sam.model import SAMConfig as JaxSAMConfig
from ovo_tpu.models.sam.model import SAMModel as JaxSAM
from ovo_tpu.models.textregion import TextRegionEmbedder as JaxTextRegion

from ovo_tpu_torch.mapping.pipeline import OVOSemMap
from ovo_tpu_torch.models.clip import CLIPModel
from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource
from ovo_tpu_torch.models.sam.model import SAMModel
from ovo_tpu_torch.models.textregion import TextRegionEmbedder

from synthetic_scene import SyntheticWallDataset
from test_torch_pipeline_e2e import make_config

AMG = dict(points_per_side=4, max_masks=16, candidates=32, gate_prompts=12,
           pred_iou_thresh=0.0, stability_thresh=0.0, nms_score_th=0.0)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_pipeline_live_sam_masks_match_jax(tmp_path):
    js = JaxSAM.random_init("hiera_test", image_size=128, seed=4)
    js = JaxSAM(JaxSAMConfig("hiera_test", 128, compute_dtype="float32"),
                js.params)
    ts = SAMModel.from_jax_params("hiera_test", 128, np_tree(js.params),
                                  device="cpu", compute_dtype="float32")
    jc = JaxCLIP.random_init("tiny-pe")
    tc = CLIPModel.from_jax_params("tiny-pe", np_tree(jc.params),
                                   device="cpu")
    cfg = make_config(32)
    cfg["semantic"]["sam"] = {"precomputed": False}
    j = JaxOVOSemMap(copy.deepcopy(cfg), tmp_path / "jax",
                     mask_source=JaxAMG(js, **AMG),
                     embedder=JaxTextRegion(jc),
                     dataset=SyntheticWallDataset(n_frames=12))
    j.run()
    t = OVOSemMap(copy.deepcopy(cfg), tmp_path / "torch",
                  mask_source=AutomaticMaskSource(ts, **AMG),
                  embedder=TextRegionEmbedder(tc),
                  dataset=SyntheticWallDataset(n_frames=12), device="cpu")
    t.run()

    jm, tm = j.slam_backbone.get_map(), t.slam_backbone.get_map()
    n = int(jm.count)
    assert n > 1000 and int(tm.count) == n
    np.testing.assert_array_equal(tm.obj_ids[:n].numpy(),
                                  np.asarray(jm.obj_ids[:n]))
    np.testing.assert_array_equal(t.ovo.active_ids(), j.ovo.active_ids())
    assert len(t.ovo.active_ids()) >= 1
    assert t.ovo.kf_id == j.ovo.kf_id == 6
    has = t.ovo.store.has_clip.numpy()
    np.testing.assert_array_equal(has, np.asarray(j.ovo.store.has_clip))
    a = t.ovo.store.clip_feature.numpy()[has]
    b = np.asarray(j.ovo.store.clip_feature)[has]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    assert len(cos) >= 1
    np.testing.assert_allclose(cos, 1.0, atol=1e-6)
