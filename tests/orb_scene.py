"""A curved, textured wall for the ORB tier's tests: ``synthetic_scene``'s
labelled wall regions on a height field, the camera going out along +x and
back.

Everything is a function of world coordinates (the tracker needs a static
world). The wall's depth varies across the frame, so no map point lies on
the frustum's near or far plane (on the flat wall every point does, and
the plane test's rounding decides: XLA fuses its multiply-adds, PyTorch
rounds each op). The one-pixel border has no depth, as in the other
parity scenes.
"""
from __future__ import annotations

import numpy as np

from synthetic_scene import H, W, WALL_Z, label_at, make_camera


def surface_z(x, y):
    return (WALL_Z + 0.3 * np.sin(1.3 * x + 0.5) * np.cos(0.9 * y + 0.2)
            + 0.08 * np.sin(3.1 * x + 2.3 * y + 1.0))


class CurvedWallDataset:
    """Duck-typed dataset: __getitem__ -> (id, image, depth, c2w)."""

    def __init__(self, n_frames: int = 40, step: float = 0.05,
                 noise_sigma: float = 15.0):
        self.K = make_camera()
        self.intrinsics = self.K
        self.height, self.width = H, W
        self.crop_edge = 0
        self.dataset_config = {"H": H, "W": W}
        self.noise_sigma = noise_sigma
        self.poses = []
        for i in range(n_frames):
            c2w = np.eye(4, dtype=np.float32)
            c2w[0, 3] = min(i, n_frames - i) * step
            self.poses.append(c2w)

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, index):
        c = self.poses[index][:3, 3].astype(np.float64)
        v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        dx = (u - self.K[0, 2]) / self.K[0, 0]
        dy = (v - self.K[1, 2]) / self.K[1, 1]
        t = np.full(dx.shape, WALL_Z - c[2])
        for _ in range(20):  # ray / height-field fixed point
            t = surface_z(c[0] + t * dx, c[1] + t * dy) - c[2]
        x, y = c[0] + t * dx, c[1] + t * dy
        depth = t.astype(np.float32)
        depth[[0, -1]] = 0.0
        depth[:, [0, -1]] = 0.0
        nz = np.random.default_rng(1000 + index).normal(
            0, self.noise_sigma, (H, W)) if self.noise_sigma > 0 else 0
        image = np.zeros((H, W, 3), np.uint8)
        image[..., 0] = label_at(x, y)
        tex_g = 128 + 90 * np.cos(2.2 * x + 0.7) * np.sin(2.7 * y + 0.3)
        tex_b = 128 + 90 * np.sin(3.0 * x) * np.cos(3.5 * y)
        image[..., 1] = np.clip(tex_g + nz, 0, 255).astype(np.uint8)
        image[..., 2] = np.clip(tex_b + nz, 0, 255).astype(np.uint8)
        return index, image, depth, self.poses[index]
