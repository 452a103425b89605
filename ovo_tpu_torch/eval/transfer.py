"""GT-mesh label transfer (port of ``ovo_tpu/eval/transfer.py``): a kNN
vote from the predicted point cloud onto the mesh vertices, on the host
with scipy's KDTree (k = 5); a tied vote goes to the smallest label.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import KDTree
from scipy import stats


def match_labels_to_vtx(points_3d_labels: np.ndarray, points_3d: np.ndarray,
                        mesh_vtx: np.ndarray, filter_unassigned: bool = True,
                        verbose: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    labels = np.asarray(points_3d_labels).reshape(-1)
    pts = np.asarray(points_3d)
    if filter_unassigned:
        mask = labels > -1
        if verbose:
            print(f"Assigned points {mask.sum()}, {mask.mean() * 100:.1f}")
        labels = labels[mask]
        pts = pts[mask]
        assert len(labels), "All points are unassigned"

    tree = KDTree(pts)
    _, indices = tree.query(mesh_vtx, k=5)
    knn_labels = labels[indices]                      # (Nv, 5)
    mesh_labels = stats.mode(knn_labels, axis=1, keepdims=False).mode

    matched_ids = np.unique(mesh_labels)
    if not filter_unassigned:
        matched_ids = matched_ids[matched_ids >= 0]
    masks = mesh_labels[None, :] == matched_ids[:, None]
    return mesh_labels, masks, matched_ids
