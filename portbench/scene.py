"""The seeded scene a cell streams: a textured height-field wall seen by a
camera that sweeps along it and back, rendered on the device and kept in
host memory as the frames a dataset reader returns.

The texture and the depth are functions of world position (a wall of
coloured 0.5 m cells under a shading wave, 3 m from the camera), so a
revisited pose sees the same surface and the map and instance set settle.
The seed draws the palette and the phases only: every seed renders the same
trajectory, frame count and sizes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

FIXED_POINT_PASSES = 12   # ray / height-field fixed point (a contraction)
CELL_M = 0.5


def trajectory(n: int) -> np.ndarray:
    """(n, 4, 4) f32 camera-to-world poses: 2.4 m along x with a small
    sway in y and z, looking down +z at the wall."""
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    i = np.arange(n, dtype=np.float64)
    poses[:, 0, 3] = -1.2 + 2.4 * i / max(n - 1, 1)
    poses[:, 1, 3] = 0.15 * np.sin(i / 7.0)
    poses[:, 2, 3] = 0.1 * np.cos(i / 9.0)
    return poses


class WallScene:
    """The wall's seeded look: ``render`` draws a view on the device."""

    def __init__(self, seed: int, device: torch.device):
        gen = torch.Generator(device=device).manual_seed(seed)
        self.phase = torch.rand(4, generator=gen, device=device) * 2 * math.pi
        self.palette = torch.randint(40, 230, (4096, 3), generator=gen,
                                     device=device).float()
        self.device = device

    def surface_z(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        p = self.phase
        return (3.0 + 0.25 * torch.sin(1.3 * x + p[0]) * torch.cos(0.9 * y + p[1])
                + 0.1 * torch.sin(3.1 * x + 2.3 * y + p[2]))

    @torch.no_grad()
    def render(self, c2w: np.ndarray, H: int, W: int, fx: float, fy: float,
               cx: float, cy: float):
        """One view: (image (H, W, 3) u8, depth (H, W) f32 metres)."""
        dev = self.device
        v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                              torch.arange(W, dtype=torch.float32, device=dev),
                              indexing="ij")
        dx, dy = (u - cx) / fx, (v - cy) / fy
        c = [float(t) for t in c2w[:3, 3]]
        t = torch.full_like(dx, 3.0 - c[2])
        for _ in range(FIXED_POINT_PASSES):
            t = self.surface_z(c[0] + t * dx, c[1] + t * dy) - c[2]
        x, y = c[0] + t * dx, c[1] + t * dy
        cell = (torch.floor(x / CELL_M).long() % 64) + 64 * (
            torch.floor(y / CELL_M).long() % 64)
        shade = 0.75 + 0.25 * torch.sin(7.0 * x + self.phase[3]) * torch.cos(5.0 * y)
        image = (self.palette[cell] * shade[..., None]).clamp(0, 255)
        return image.to(torch.uint8), t


def _to_host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.cpu().numpy())


class ReplayDataset:
    """A recorded scene replayed out and back: frame id ``fid`` shows
    distinct frame ``pingpong(fid)`` with its pose, so ids keep rising while
    the views repeat. Duck-types ``data/datasets`` readers: ``__getitem__``
    only indexes host arrays; ``__len__`` is the run's frame count, which
    the caller sets (``n_frames``).

    ``kind`` ``"replica"``: (id, color (H, W, 3) u8, depth (H, W) f32, c2w).
    ``"scannet"``: (id, low-res color, depth, c2w, full-res color), the
    depth and low-res color cropped by ``crop_edge`` and deeper readings
    than ``depth_th`` zeroed, as ``data/datasets.ScanNet`` returns them."""

    def __init__(self, traffic: Dict[str, Any], seed: int,
                 device: torch.device):
        cam = traffic["program"]["cam"]
        self.kind = traffic["program"]["dataset_name"]
        n = int(traffic["distinct_frames"])
        self.poses = trajectory(n)
        scene = WallScene(seed, device)
        H, W = int(cam["H"]), int(cam["W"])
        fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
        self.dataset_config = dict(cam)
        self.crop_edge = int(cam.get("crop_edge", 0))
        e = self.crop_edge
        self.height, self.width = H - 2 * e, W - 2 * e
        self.intrinsics = np.array([[fx, 0, cx - e], [0, fy, cy - e],
                                    [0, 0, 1]], np.float64)
        self.frames: List[tuple] = []
        full = traffic.get("full_color_hw")
        for i in range(n):
            image, depth = scene.render(self.poses[i], H, W, fx, fy, cx, cy)
            th = cam.get("depth_th", 0)
            if th and th > 0:
                depth = torch.where(depth > th, torch.zeros_like(depth), depth)
            if e:
                image, depth = image[e:-e, e:-e], depth[e:-e, e:-e]
            item = [_to_host(image), _to_host(depth)]
            if full is not None:
                sh, sw = full[0] / H, full[1] / W
                color, _ = scene.render(self.poses[i], full[0], full[1],
                                        fx * sw, fy * sh, (cx + 0.5) * sw - 0.5,
                                        (cy + 0.5) * sh - 0.5)
                item.append(_to_host(color))
            self.frames.append(tuple(item))
        self.n_frames = 0

    def index(self, fid: int) -> int:
        """The distinct frame that frame id ``fid`` shows."""
        n = len(self.frames)
        period = max(2 * n - 2, 1)
        k = fid % period
        return k if k < n else period - k

    def __len__(self) -> int:
        return self.n_frames

    def __getitem__(self, fid: int):
        k = self.index(fid)
        f = self.frames[k]
        if self.kind == "scannet":
            return fid, f[0], f[1], self.poses[k], f[2]
        return fid, f[0], f[1], self.poses[k]

    def segment_image(self, fid: int) -> np.ndarray:
        """The image the mask source segments at frame ``fid``."""
        f = self.frames[self.index(fid)]
        return f[2] if self.kind == "scannet" else f[0]
