"""The traffic generator: the same seed gives the same frames, every seed
the same trajectory, sizes and frame ids."""
import numpy as np
import pytest
import torch

from portbench import scene
from portbench.tests.tiny_cell import CAM


def _traffic(kind="replica", full=None):
    t = {"program": {"dataset_name": kind, "cam": dict(CAM)},
         "distinct_frames": 5}
    if full:
        t["full_color_hw"] = full
    return t


def _frames(ds):
    return [np.concatenate([np.asarray(a, np.float64).ravel()
                            for a in ds[i][1:]]) for i in range(8)]


@pytest.mark.parametrize("kind,full", [("replica", None),
                                       ("scannet", (72, 96))])
def test_same_seed_same_frames(kind, full):
    t = _traffic(kind, full)
    if kind == "scannet":
        t["program"]["cam"].update(crop_edge=2, depth_th=3.1)
    seed = 2 ** 33 + 7
    a = scene.ReplayDataset(t, seed, torch.device("cpu"))
    b = scene.ReplayDataset(t, seed, torch.device("cpu"))
    a.n_frames = b.n_frames = 8
    for x, y in zip(_frames(a), _frames(b)):
        np.testing.assert_array_equal(x, y)
    c = scene.ReplayDataset(t, seed + 1, torch.device("cpu"))
    c.n_frames = 8
    assert any(not np.array_equal(x, y) for x, y in zip(_frames(a), _frames(c)))
    # the seed draws the look only: poses, sizes and ids agree
    for i in range(8):
        fa, fc = a[i], c[i]
        assert fa[0] == fc[0] == i
        np.testing.assert_array_equal(fa[3], fc[3])
        assert [np.shape(x) for x in fa[1:]] == [np.shape(x) for x in fc[1:]]


def test_scannet_tuple_shapes_and_depth_threshold():
    t = _traffic("scannet", (72, 96))
    t["program"]["cam"].update(crop_edge=2, depth_th=3.1)
    ds = scene.ReplayDataset(t, 5, torch.device("cpu"))
    ds.n_frames = 3
    fid, lr, depth, c2w, full = ds[2]
    assert lr.shape == (44, 60, 3) and depth.shape == (44, 60)
    assert full.shape == (72, 96, 3) and full.dtype == np.uint8
    assert depth.max() <= 3.1 and (depth > 0).any()
    assert ds.height == 44 and ds.width == 60
    assert ds.intrinsics[0, 2] == CAM["cx"] - 2
    np.testing.assert_array_equal(ds.segment_image(2), full)


def test_out_and_back_ids_keep_rising():
    ds = scene.ReplayDataset(_traffic(), 1, torch.device("cpu"))
    assert [ds.index(f) for f in range(12)] == [0, 1, 2, 3, 4, 3, 2, 1, 0,
                                               1, 2, 3]
    ds.n_frames = 12
    np.testing.assert_array_equal(ds[3][1], ds[5][1])
    assert ds[5][0] == 5 and len(ds) == 12
