"""A Replica-layout scene for the port's CLI tests, written without cv2:
``scripts/make_smoke_scene.py``'s wall and floor, frames as PNG."""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]
import make_smoke_scene as smoke  # noqa: E402

from ovo_tpu_torch.data import images  # noqa: E402


def write_replica_scene(root: Path, scene: str, frames: int) -> None:
    """``make_smoke_scene``'s wall-and-floor scene in the Replica layout,
    colour and depth written as PNG (the colour under the ``.jpg`` names
    Replica globs: both readers decode by content). The one-pixel border
    has no depth, as in the association tests: XLA fuses the projection's
    f32 multiply-adds where PyTorch rounds each op, so a border pixel
    projected back can fall on either side of the frustum's edge."""
    rep = root / "data/input/Datasets/Replica"
    res = rep / scene / "results"
    res.mkdir(parents=True, exist_ok=True)
    (rep / "semantic_gt").mkdir(parents=True, exist_ok=True)
    poses = []
    for i in range(frames):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3], c2w[2, 3] = 0.02 * i, -0.01 * i
        rgb, depth, pts, label = smoke.render(c2w)
        depth[[0, -1]] = 0.0
        depth[:, [0, -1]] = 0.0
        images.write_png(res / f"frame{i:04d}.jpg", rgb, filter_type=i % 5)
        images.write_png(res / f"depth{i:04d}.png", np.clip(
            depth * smoke.DEPTH_SCALE, 0, 65535).astype(np.uint16))
        poses.append(c2w.reshape(-1))
        if i == 0:
            keep = depth.reshape(-1) > 0
            gt_pts, gt_labels = (pts.reshape(-1, 3)[keep][::3],
                                 label.reshape(-1)[keep][::3])
    np.savetxt(rep / scene / "traj.txt", np.stack(poses), fmt="%.8f")
    np.savetxt(rep / "semantic_gt" / f"{scene}.txt", gt_labels, fmt="%d")
    with open(rep / f"{scene}_mesh.ply", "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(gt_pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        for p in gt_pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
