"""The Gaussian-SLAM backbone end to end through both packages:
``OVOSemMap`` with ``slam_module: gaussian_slam`` on the scene and config
of the reference's ``test_gaussian_backbone_in_pipeline``
(``tests/test_gaussian_slam.py``), GT poses, a mapped keyframe every
second frame (12 Adam iterations each), masks every fourth.

Held as the reference test holds its own run, and across the packages:
each run keeps over 500 live gaussians, three or more instances, and
instance ids on over 30% of the live gaussians; both have the same
keyframes, poses and minted instances; the instance sets equal; the
checkpoint carries the gaussian key layout and restores the live count.
The frame-0 map, seeded before any render, has equal live counts; the
final ones agree within 5%: Adam normalizes each step, so a parameter
whose gradient is at rounding level moves a full step either way, and
the later keyframes' seeding gates (alpha, depth error against 50 x the
median) read renders of those parameters. Either package alone, its
input colours moved by 1e-6, ends a few percent apart from itself.
"""
import copy

import numpy as np
import pytest
import torch

from ovo_tpu.data.masks import CallableMaskSource as JaxMasks
from ovo_tpu.data.masks import RecordedEmbedder as JaxRecorded
from ovo_tpu.mapping.pipeline import OVOSemMap as JaxOVOSemMap

from ovo_tpu_torch.data.masks import CallableMaskSource, RecordedEmbedder
from ovo_tpu_torch.mapping.pipeline import OVOSemMap
from ovo_tpu_torch.slam.gaussian.model import n_valid
from ovo_tpu_torch.utils import io as io_utils

from synthetic_scene import (SyntheticWallDataset, class_embeddings,
                             mask_label_fn, synthetic_mask_fn)

CONFIG = {
    "dataset_name": "synthetic", "use_wandb": False, "debug": False,
    "slam": {"slam_module": "gaussian_slam", "save_estimated_cam": True},
    # seeds at the true depth: the flat wall's 1.005 * depth would put
    # every seed behind the association frustum's far plane
    "mapping": {"map_every": 2, "iterations": 12, "max_seeds": 2048,
                "n_gaussians_capacity": 1 << 15, "keyframe_window": 3,
                "k_per_tile": 32, "seed_depth_mult": 1.0},
    "tracking": {"track_every": 1, "gt_camera": True},
    "data": {"scene_name": "wall0"}, "cam": {},
    "semantic": {
        "segment_every": 4, "match_distance_th": 0.1, "track_th": 30,
        "depth_filter": False, "log": False, "kf_queue_delay": 1,
        "capacity": {"n_instances": 64, "n_masks": 16},
        "clip": {"k_top_views": 10000, "fusion": "avg_pooling",
                 "clip_dim": 16},
    },
}


class FirstMap:
    """Records the backbone's live count after its first mapped frame."""

    def __init__(self, backbone, count):
        self.count = None
        inner = backbone.map

        def map_(*a, **kw):
            inner(*a, **kw)
            if self.count is None:
                self.count = count(backbone)

        backbone.map = map_


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the tests share
    the machine's cores with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gaussian_pipeline_matches_jax(tmp_path):
    embeds = class_embeddings(16)
    j = JaxOVOSemMap(copy.deepcopy(CONFIG), tmp_path / "jax",
                     mask_source=JaxMasks(synthetic_mask_fn, max_masks=16),
                     embedder=JaxRecorded(16, mask_label_fn, embeds),
                     dataset=SyntheticWallDataset(n_frames=8))
    t = OVOSemMap(copy.deepcopy(CONFIG), tmp_path / "torch",
                  mask_source=CallableMaskSource(synthetic_mask_fn, 16,
                                                 "cpu"),
                  embedder=RecordedEmbedder(16, mask_label_fn, embeds,
                                            device="cpu"),
                  dataset=SyntheticWallDataset(n_frames=8), device="cpu")
    first = (FirstMap(j.slam_backbone,
                      lambda b: int(np.asarray(b.state.valid).sum())),
             FirstMap(t.slam_backbone, lambda b: n_valid(b.state)))
    j.run()
    t.run()
    jb, tb = j.slam_backbone, t.slam_backbone
    assert first[1].count == first[0].count > 500
    assert sorted(tb.kfs) == sorted(jb.kfs) == [0, 2, 4, 6]
    assert sorted(tb.estimated_c2ws) == sorted(jb.estimated_c2ws)
    for k, v in jb.estimated_c2ws.items():
        np.testing.assert_array_equal(tb.estimated_c2ws[k], v)
    n_j, n_t = int(jb.get_map().count), int(tb.get_map().count)
    assert n_j > 500 and abs(n_t - n_j) <= 0.05 * n_j, (n_t, n_j)
    assert len(t.ovo.active_ids()) >= 3
    np.testing.assert_array_equal(t.ovo.active_ids(), j.ovo.active_ids())
    assert int(t.ovo.store.next_id) == int(j.ovo.store.next_id)
    for b in (tb, jb):
        live = np.asarray(b.state.valid)
        assert (np.asarray(b.state.obj_ids)[live] >= 0).mean() > 0.3
    ckpt = io_utils.load_ckpt(tmp_path / "torch" / "ovo_map.ckpt")
    assert "f_dc" in ckpt["map_params"]
    tb.set_map_dict(ckpt["map_params"])
    assert n_valid(tb.state) == n_t
