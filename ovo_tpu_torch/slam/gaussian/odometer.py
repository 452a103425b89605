"""Frame-to-frame RGB-D visual odometry for the tracker's initial pose
(port of ``ovo_tpu/slam/gaussian/odometer.py``).

The port's native dense direct tracker (``slam/orbslam.NativeTracker``:
coarse-to-fine Gauss-Newton over Huber photometric and geometric
residuals, host C++) is fed consecutive frames; this facade reports the
relative pose between the last two.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class VisualOdometer:
    def __init__(self, fx: float, fy: float, cx: float, cy: float,
                 depth_scale: float = 1.0):
        from ..orbslam import NativeTracker

        self._tracker = NativeTracker()
        self._K = (fx, fy, cx, cy)
        self._depth_scale = depth_scale
        self._prev_c2w: Optional[np.ndarray] = None
        self._last_rel: Optional[np.ndarray] = None

    def estimate_rel_pose(self, image: np.ndarray, depth: np.ndarray
                          ) -> Optional[np.ndarray]:
        """Feed the next frame; returns the transform from the previous
        frame's camera to this one's (c2w_i = c2w_{i-1} @ rel), or None for
        the first frame and on a tracking failure."""
        img = np.asarray(image)
        if img.ndim == 3:
            gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                    + 0.114 * img[..., 2])
        else:
            gray = img
        if gray.dtype == np.uint8:
            gray = gray.astype(np.float32) / 255.0
        gray = np.ascontiguousarray(gray, np.float32)
        dep = np.ascontiguousarray(
            np.asarray(depth, np.float32) / self._depth_scale)
        fx, fy, cx, cy = self._K
        state = self._tracker.process_image_rgbd(gray, dep, fx, fy, cx, cy)
        if state < 0:
            self._prev_c2w = None
            return None
        c2w = self._tracker.get_last_trajectory_point().reshape(4, 4)
        rel = None
        if self._prev_c2w is not None:
            rel = np.linalg.inv(self._prev_c2w) @ c2w
        self._prev_c2w = c2w
        self._last_rel = rel
        return rel

    def shutdown(self) -> None:
        self._tracker.shutdown()
