"""Posed RGB-D datasets: Replica, ScanNet, ScanNet++, Matterport and TUM
RGB-D (port of ``ovo_tpu/data/datasets.py``).

The same file layouts, pose conventions, intrinsics (resize and crop
adjusted), depth scaling and returned tuples: ``(index, color u8 (H, W, 3)
RGB, depth f32 (H, W) in metres, c2w f32 (4, 4))``, and for ScanNet a fifth
item, the full-resolution colour the masks are computed on. Images are read
with ``data/images.py``: PNGs without cv2; JPEGs, linear resizes to another
size and undistortion through cv2, imported when first needed.
"""
from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Dict, List

import numpy as np

from . import images


class BaseDataset:
    def __init__(self, dataset_config: Dict):
        self.dataset_path = Path(dataset_config["input_path"])
        self.frame_limit = dataset_config.get("frame_limit", -1)
        self.dataset_config = dataset_config
        resize_ratio = dataset_config.get("resize_ratio", 1.0)
        self.height = int(dataset_config["H"] * resize_ratio)
        self.width = int(dataset_config["W"] * resize_ratio)
        self.fx = dataset_config["fx"] * resize_ratio
        self.fy = dataset_config["fy"] * resize_ratio
        self.cx = dataset_config["cx"] * resize_ratio
        self.cy = dataset_config["cy"] * resize_ratio
        self.depth_scale = dataset_config["depth_scale"]
        self.distortion = (np.array(dataset_config["distortion"])
                           if "distortion" in dataset_config else None)
        self.crop_edge = dataset_config.get("crop_edge", 0)
        if self.crop_edge:
            self.height -= 2 * self.crop_edge
            self.width -= 2 * self.crop_edge
            self.cx -= self.crop_edge
            self.cy -= self.crop_edge
        self.fovx = 2 * math.atan(self.width / (2 * self.fx))
        self.fovy = 2 * math.atan(self.height / (2 * self.fy))
        self.intrinsics = np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]])
        self.color_paths: List[Path] = []
        self.depth_paths: List[Path] = []
        self.poses: List[np.ndarray] = []

    def __len__(self):
        n = len(self.color_paths)
        return n if self.frame_limit < 0 else min(int(self.frame_limit), n)

    def _color(self, index: int) -> np.ndarray:
        """The frame's colour at the configured size, RGB uint8."""
        color = images.imread(self.color_paths[index])
        color = images.resize_linear(color, (self.width, self.height))
        return np.ascontiguousarray(color.astype(np.uint8)[..., ::-1])

    def _depth(self, index: int) -> np.ndarray:
        """The frame's depth at the configured size, in metres (f32)."""
        depth = images.imread(self.depth_paths[index],
                              images.IMREAD_UNCHANGED)
        depth = images.resize_nearest(depth.astype(float),
                                      (self.width, self.height))
        return depth.astype(np.float32) / self.depth_scale


class Replica(BaseDataset):
    def __init__(self, dataset_config: Dict):
        super().__init__(dataset_config)
        self.color_paths = sorted(
            (self.dataset_path / "results").glob("frame*.jpg"))
        self.depth_paths = sorted(
            (self.dataset_path / "results").glob("depth*.png"))
        self._load_poses(self.dataset_path / "traj.txt")
        print(f"Loaded {len(self.color_paths)} frames")

    def _load_poses(self, path):
        with open(path, "r") as f:
            for line in f:
                c2w = np.array(list(map(float, line.split()))).reshape(4, 4)
                self.poses.append(c2w.astype(np.float32))

    def __getitem__(self, index):
        return index, self._color(index), self._depth(index), \
            self.poses[index]


class ScanNet(BaseDataset):
    """Returns a 5-tuple: (id, low-res color, depth, pose, full-res color):
    segmentation runs on the full-resolution image, geometry at the depth
    resolution."""

    def __init__(self, dataset_config: Dict):
        super().__init__(dataset_config)
        self.color_paths = sorted((self.dataset_path / "color").glob("*.jpg"),
                                  key=lambda x: int(os.path.basename(x)[:-4]))
        self.depth_paths = sorted((self.dataset_path / "depth").glob("*.png"),
                                  key=lambda x: int(os.path.basename(x)[:-4]))
        self._load_poses(self.dataset_path / "pose")
        depth_th = dataset_config.get("depth_th", 0)
        self.depth_th = depth_th if depth_th > 0 else None

    def _load_poses(self, path):
        for pose_path in sorted(path.glob("*.txt"),
                                key=lambda x: int(os.path.basename(x)[:-4])):
            with open(pose_path, "r") as f:
                vals = [list(map(float, line.split(" "))) for line in f]
            self.poses.append(np.array(vals).reshape(4, 4).astype(np.float32))

    def __getitem__(self, index):
        color = images.imread(self.color_paths[index])
        if self.distortion is not None:
            color = images.undistort(color, self.intrinsics, self.distortion)
        color = np.ascontiguousarray(color[..., ::-1])
        lr_color = images.resize_linear(color, (self.dataset_config["W"],
                                                self.dataset_config["H"]))
        depth = images.imread(self.depth_paths[index],
                              images.IMREAD_UNCHANGED)
        depth = depth.astype(np.float32) / self.depth_scale
        if self.depth_th is not None:
            depth[depth > self.depth_th] = 0
        edge = self.crop_edge
        if edge > 0:
            lr_color = lr_color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
        return index, lr_color, depth, self.poses[index], color


class ScanNetPP(BaseDataset):
    def __init__(self, dataset_config: Dict):
        super().__init__(dataset_config)
        self.use_train_split = dataset_config["use_train_split"]
        split = json.load(open(self.dataset_path / "dslr" /
                               "train_test_lists.json"))
        self.image_names = split["train" if self.use_train_split else "test"]
        self._load_data()

    def _load_data(self):
        cams = json.load(open(self.dataset_path / "dslr" / "nerfstudio" /
                              "transforms_undistorted.json"))
        frames = cams["frames" if self.use_train_split else "test_frames"]
        by_name = {f["file_path"]: f for f in frames}
        P = np.diag([1, -1, -1, 1]).astype(np.float32)
        for name in self.image_names:
            meta = by_name[name]
            self.color_paths.append(
                self.dataset_path / "dslr" / "undistorted_images" / name)
            self.depth_paths.append(
                self.dataset_path / "dslr" / "undistorted_projected_depth" /
                name.replace(".JPG", ".png"))
            c2w = np.array(meta["transform_matrix"]).astype(np.float32)
            self.poses.append(P @ c2w @ P.T)

    def __len__(self):
        n = len(self.image_names)
        if self.use_train_split and self.frame_limit >= 0:
            return min(int(self.frame_limit), n)
        return n

    def __getitem__(self, index):
        # the colour as imageio reads it (RGB), the depth as cv2 does
        import imageio.v2 as imageio

        color = np.asarray(imageio.imread(self.color_paths[index]),
                           dtype=float)
        color = images.resize_linear(color, (self.width, self.height))
        color = color.astype(np.uint8)
        depth = images.imread(self.depth_paths[index],
                              images.IMREAD_UNCHANGED).astype(np.int64)
        depth = images.resize_nearest(depth.astype(float),
                                      (self.width, self.height))
        depth = depth.astype(np.float32) / self.depth_scale
        return index, color, depth, self.poses[index]


class Matterport(BaseDataset):
    def __init__(self, dataset_config: Dict):
        super().__init__(dataset_config)
        self.color_paths = sorted((self.dataset_path / "rgb").glob("*.png"))
        self.depth_paths = sorted((self.dataset_path / "depth").glob("*.png"))
        self._load_poses(self.dataset_path / "pose")
        print(f"Loaded {len(self.color_paths)} frames")

    def _load_poses(self, path):
        C = np.diag([1.0, -1.0, -1.0, 1.0])
        for pose_file in sorted(os.listdir(path)):
            c2w = np.loadtxt(str(path / pose_file)).reshape(4, 4)
            self.poses.append((c2w @ C).astype(np.float32))

    def __getitem__(self, index):
        return index, self._color(index), self._depth(index), \
            self.poses[index]


class TUM_RGBD(BaseDataset):
    """TUM RGB-D: rgb / depth / ground-truth lists associated by the
    nearest timestamp within ``max_dt``, subsampled to ``frame_rate``."""

    def __init__(self, dataset_config: Dict):
        super().__init__(dataset_config)
        self._load_tum(self.dataset_path,
                       frame_rate=dataset_config.get("frame_rate", 32))
        print(f"Loaded {len(self.color_paths)} frames")

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=str,
                          skiprows=skiprows)

    @staticmethod
    def _associate_frames(tstamp_image, tstamp_depth, tstamp_pose,
                          max_dt: float = 0.08):
        associations = []
        for i, t in enumerate(tstamp_image):
            j = np.argmin(np.abs(tstamp_depth - t))
            if tstamp_pose is None:
                if np.abs(tstamp_depth[j] - t) < max_dt:
                    associations.append((i, j))
            else:
                k = np.argmin(np.abs(tstamp_pose - t))
                if (np.abs(tstamp_depth[j] - t) < max_dt
                        and np.abs(tstamp_pose[k] - t) < max_dt):
                    associations.append((i, j, k))
        return associations

    def _load_tum(self, datapath: Path, frame_rate: int = -1):
        from scipy.spatial.transform import Rotation

        if (datapath / "groundtruth.txt").exists():
            pose_list = datapath / "groundtruth.txt"
        else:
            pose_list = datapath / "pose.txt"
        image_data = self._parse_list(datapath / "rgb.txt", skiprows=3)
        depth_data = self._parse_list(datapath / "depth.txt", skiprows=3)
        pose_data = self._parse_list(pose_list, skiprows=3)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        tstamp_image = image_data[:, 0].astype(np.float64)
        tstamp_depth = depth_data[:, 0].astype(np.float64)
        tstamp_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate_frames(tstamp_image, tstamp_depth,
                                       tstamp_pose)

        indices = [0]
        for i in range(1, len(assoc)):
            t0 = tstamp_image[assoc[indices[-1]][0]]
            t1 = tstamp_image[assoc[i][0]]
            if frame_rate <= 0 or t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        for ix in indices:
            i, j, k = assoc[ix]
            self.color_paths.append(datapath / image_data[i, 1])
            self.depth_paths.append(datapath / depth_data[j, 1])
            quat = pose_vecs[k][3:]          # tx ty tz qx qy qz qw
            trans = pose_vecs[k][:3]
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(quat).as_matrix()
            c2w[:3, 3] = trans
            self.poses.append(c2w.astype(np.float32))

    def __getitem__(self, index):
        color = images.imread(self.color_paths[index])
        if self.distortion is not None:
            K = np.eye(3)
            K[0, 0], K[1, 1] = self.fx, self.fy
            K[0, 2], K[1, 2] = self.cx, self.cy
            color = images.undistort(color, K, self.distortion)
        color = np.ascontiguousarray(color[..., ::-1].astype(np.uint8))
        depth = images.imread(self.depth_paths[index],
                              images.IMREAD_UNCHANGED)
        depth = depth.astype(np.float32) / self.depth_scale
        edge = self.crop_edge
        if edge > 0:
            color = color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
        return index, color, depth, self.poses[index]


_REGISTRY = {"replica": Replica, "scannet": ScanNet, "scannetpp": ScanNetPP,
             "matterport": Matterport, "tum_rgbd": TUM_RGBD}


def get_dataset(dataset_name: str):
    try:
        return _REGISTRY[dataset_name.lower()]
    except KeyError:
        raise NotImplementedError(f"Dataset {dataset_name} not implemented")
