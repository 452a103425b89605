"""Visualization and the interactive query (port of
``ovo_tpu/viz/visualizer.py``; host numpy only, no torch).

Without open3d (neither the CPU test machine nor the card's has it) the
viewer is headless: colored PLY snapshots and query heatmaps, so runs stay
inspectable; with open3d installed, ``InteractiveViewer`` and the stream's
live window take its place (ported as the reference wrote them; run on no
machine yet). ``stream_pcd`` is the viewer-process side of the pipeline's
live stream and query handshake (``mapping/pipeline.OVOSemMap.
enable_stream``).

Instance colors cycle tab20 as the reference does; query heatmaps index
the 256-entry viridis table matplotlib's ``cm.viridis`` holds (here as a
constant: the card's machine has no matplotlib), the way matplotlib
indexes it.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np


def _has_o3d() -> bool:
    return importlib.util.find_spec("open3d") is not None


_TAB20 = np.array([
    [31, 119, 180], [174, 199, 232], [255, 127, 14], [255, 187, 120],
    [44, 160, 44], [152, 223, 138], [214, 39, 40], [255, 152, 150],
    [148, 103, 189], [197, 176, 213], [140, 86, 75], [196, 156, 148],
    [227, 119, 194], [247, 182, 210], [127, 127, 127], [199, 199, 199],
    [188, 189, 34], [219, 219, 141], [23, 190, 207], [158, 218, 229],
], dtype=np.uint8)

# matplotlib's viridis colormap (256 entries), each RGB entry times 255
# truncated to uint8 as the reference's heatmap_colors does
_VIRIDIS_U8 = np.array([
    68, 1, 84, 68, 2, 85, 68, 3, 87, 69, 5, 88, 69, 6, 90, 69, 8, 91, 70, 9,
    92, 70, 11, 94, 70, 12, 95, 70, 14, 97, 71, 15, 98, 71, 17, 99, 71, 18,
    101, 71, 20, 102, 71, 21, 103, 71, 22, 105, 71, 24, 106, 72, 25, 107, 72,
    26, 108, 72, 28, 110, 72, 29, 111, 72, 30, 112, 72, 32, 113, 72, 33, 114,
    72, 34, 115, 72, 35, 116, 71, 37, 117, 71, 38, 118, 71, 39, 119, 71, 40,
    120, 71, 42, 121, 71, 43, 122, 71, 44, 123, 70, 45, 124, 70, 47, 124, 70,
    48, 125, 70, 49, 126, 69, 50, 127, 69, 52, 127, 69, 53, 128, 69, 54, 129,
    68, 55, 129, 68, 57, 130, 67, 58, 131, 67, 59, 131, 67, 60, 132, 66, 61,
    132, 66, 62, 133, 66, 64, 133, 65, 65, 134, 65, 66, 134, 64, 67, 135, 64,
    68, 135, 63, 69, 135, 63, 71, 136, 62, 72, 136, 62, 73, 137, 61, 74, 137,
    61, 75, 137, 61, 76, 137, 60, 77, 138, 60, 78, 138, 59, 80, 138, 59, 81,
    138, 58, 82, 139, 58, 83, 139, 57, 84, 139, 57, 85, 139, 56, 86, 139, 56,
    87, 140, 55, 88, 140, 55, 89, 140, 54, 90, 140, 54, 91, 140, 53, 92, 140,
    53, 93, 140, 52, 94, 141, 52, 95, 141, 51, 96, 141, 51, 97, 141, 50, 98,
    141, 50, 99, 141, 49, 100, 141, 49, 101, 141, 49, 102, 141, 48, 103, 141,
    48, 104, 141, 47, 105, 141, 47, 106, 141, 46, 107, 142, 46, 108, 142, 46,
    109, 142, 45, 110, 142, 45, 111, 142, 44, 112, 142, 44, 113, 142, 44, 114,
    142, 43, 115, 142, 43, 116, 142, 42, 117, 142, 42, 118, 142, 42, 119, 142,
    41, 120, 142, 41, 121, 142, 40, 122, 142, 40, 122, 142, 40, 123, 142, 39,
    124, 142, 39, 125, 142, 39, 126, 142, 38, 127, 142, 38, 128, 142, 38, 129,
    142, 37, 130, 142, 37, 131, 141, 36, 132, 141, 36, 133, 141, 36, 134, 141,
    35, 135, 141, 35, 136, 141, 35, 137, 141, 34, 137, 141, 34, 138, 141, 34,
    139, 141, 33, 140, 141, 33, 141, 140, 33, 142, 140, 32, 143, 140, 32, 144,
    140, 32, 145, 140, 31, 146, 140, 31, 147, 139, 31, 148, 139, 31, 149, 139,
    31, 150, 139, 30, 151, 138, 30, 152, 138, 30, 153, 138, 30, 153, 138, 30,
    154, 137, 30, 155, 137, 30, 156, 137, 30, 157, 136, 30, 158, 136, 30, 159,
    136, 30, 160, 135, 31, 161, 135, 31, 162, 134, 31, 163, 134, 32, 164, 133,
    32, 165, 133, 33, 166, 133, 33, 167, 132, 34, 167, 132, 35, 168, 131, 35,
    169, 130, 36, 170, 130, 37, 171, 129, 38, 172, 129, 39, 173, 128, 40, 174,
    127, 41, 175, 127, 42, 176, 126, 43, 177, 125, 44, 177, 125, 46, 178, 124,
    47, 179, 123, 48, 180, 122, 50, 181, 122, 51, 182, 121, 53, 183, 120, 54,
    184, 119, 56, 185, 118, 57, 185, 118, 59, 186, 117, 61, 187, 116, 62, 188,
    115, 64, 189, 114, 66, 190, 113, 68, 190, 112, 69, 191, 111, 71, 192, 110,
    73, 193, 109, 75, 194, 108, 77, 194, 107, 79, 195, 105, 81, 196, 104, 83,
    197, 103, 85, 198, 102, 87, 198, 101, 89, 199, 100, 91, 200, 98, 94, 201,
    97, 96, 201, 96, 98, 202, 95, 100, 203, 93, 103, 204, 92, 105, 204, 91,
    107, 205, 89, 109, 206, 88, 112, 206, 86, 114, 207, 85, 116, 208, 84, 119,
    208, 82, 121, 209, 81, 124, 210, 79, 126, 210, 78, 129, 211, 76, 131, 211,
    75, 134, 212, 73, 136, 213, 71, 139, 213, 70, 141, 214, 68, 144, 214, 67,
    146, 215, 65, 149, 215, 63, 151, 216, 62, 154, 216, 60, 157, 217, 58, 159,
    217, 56, 162, 218, 55, 165, 218, 53, 167, 219, 51, 170, 219, 50, 173, 220,
    48, 175, 220, 46, 178, 221, 44, 181, 221, 43, 183, 221, 41, 186, 222, 39,
    189, 222, 38, 191, 223, 36, 194, 223, 34, 197, 223, 33, 199, 224, 31, 202,
    224, 30, 205, 224, 29, 207, 225, 28, 210, 225, 27, 212, 225, 26, 215, 226,
    25, 218, 226, 24, 220, 226, 24, 223, 227, 24, 225, 227, 24, 228, 227, 24,
    231, 228, 25, 233, 228, 25, 236, 228, 26, 238, 229, 27, 241, 229, 28, 243,
    229, 30, 246, 230, 31, 248, 230, 33, 250, 230, 34, 253, 231, 36,
], dtype=np.uint8).reshape(256, 3)


def instance_colors(obj_ids: np.ndarray) -> np.ndarray:
    """tab20-cycled per-instance colors; unassigned points grey."""
    colors = _TAB20[np.abs(obj_ids) % len(_TAB20)]
    colors[obj_ids < 0] = 128
    return colors


def heatmap_colors(values: np.ndarray, threshold: float = 0.0) -> np.ndarray:
    """Viridis heat coloring of similarity values in [0, 1], as
    ``cm.viridis``: index int(v * 256), 1.0 on the last entry; NaN takes
    matplotlib's bad color (black); values under ``threshold`` grey."""
    values = np.asarray(values)
    v = np.clip(values, 0.0, 1.0)
    bad = np.isnan(v)
    idx = np.minimum((np.where(bad, 0.0, v) * 256).astype(np.int64), 255)
    rgb = _VIRIDIS_U8[idx]
    rgb[bad] = 0
    rgb[values < threshold] = 60
    return rgb


_PLY_VERTEX = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("r", "u1"), ("g", "u1"), ("b", "u1")])


def write_ply(path, points: np.ndarray, colors: np.ndarray) -> None:
    """Binary little-endian PLY of colored points (the reference's bytes,
    packed at once)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    n = min(len(points), len(colors))
    rows = np.empty(n, _PLY_VERTEX)
    for i, k in enumerate("xyz"):
        rows[k] = points[:n, i]
    for i, k in enumerate("rgb"):
        rows[k] = colors[:n, i]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(points)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"property uchar red\nproperty uchar green\n"
                b"property uchar blue\nend_header\n")
        f.write(rows.tobytes())


def export_colored_pcd(output_dir, points, obj_ids, rgb_colors=None,
                       query_values=None, tag: str = "map") -> None:
    """Headless snapshot set: instance-colored, RGB, and optional
    query-heatmap clouds."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points)
    obj_ids = np.asarray(obj_ids).reshape(-1)
    write_ply(out / f"{tag}_instances.ply", points, instance_colors(obj_ids))
    if rgb_colors is not None:
        write_ply(out / f"{tag}_rgb.ply", points, np.asarray(rgb_colors))
    if query_values is not None:
        write_ply(out / f"{tag}_query.ply", points,
                  heatmap_colors(np.asarray(query_values)))


def instance_obbs(points: np.ndarray, obj_ids: np.ndarray) -> dict:
    """Per-instance oriented bounding boxes (the reference's
    visualizer.py:401-599 ``visualize_3d_points_obj_id_and_obb`` uses
    open3d OBBs; here: PCA-aligned boxes computed directly). Returns
    {id: {center, axes (3,3 rows = directions), extent (3,)}}."""
    out = {}
    for ins_id in np.unique(obj_ids):
        if ins_id < 0:
            continue
        pts = points[obj_ids == ins_id]
        if len(pts) < 4:
            continue
        c = pts.mean(axis=0)
        x = pts - c
        cov = x.T @ x / len(x)
        w, v = np.linalg.eigh(cov)          # ascending eigenvalues
        axes = v.T[::-1]                     # rows: major->minor directions
        proj = x @ axes.T
        lo, hi = proj.min(axis=0), proj.max(axis=0)
        center = c + 0.5 * (lo + hi) @ axes
        out[int(ins_id)] = {"center": center, "axes": axes,
                            "extent": (hi - lo)}
    return out


def obb_corners(obb: dict) -> np.ndarray:
    """(8, 3) world-space corners of one OBB."""
    signs = np.array([[sx, sy, sz] for sx in (-.5, .5) for sy in (-.5, .5)
                      for sz in (-.5, .5)])
    return obb["center"] + (signs * obb["extent"]) @ obb["axes"]


_OBB_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
              (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]


def export_obb_lineset(path, obbs: dict, samples_per_edge: int = 24) -> None:
    """Headless OBB view: wireframes rendered as dense point samples along
    the 12 edges of each box (PLY points are viewer-agnostic)."""
    pts, cols = [], []
    t = np.linspace(0.0, 1.0, samples_per_edge)[:, None]
    for ins_id, obb in obbs.items():
        corners = obb_corners(obb)
        color = instance_colors(np.array([ins_id]))[0]
        for a, b in _OBB_EDGES:
            seg = corners[a] * (1 - t) + corners[b] * t
            pts.append(seg)
            cols.append(np.tile(color, (samples_per_edge, 1)))
    if not pts:
        return
    write_ply(path, np.concatenate(pts), np.concatenate(cols))


def camera_frustum_lineset(c2w: np.ndarray, K: np.ndarray,
                           hw: Tuple[int, int], depth: float = 0.3
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Camera frustum wireframe in world coords (reference
    vis_utils.py:118-158): optical center + the 4 image-plane corners at
    ``depth``, 8 lines (4 center->corner rays + the corner ring).
    Returns (points (5, 3) f64, lines (8, 2) i32)."""
    h, w = hw
    corners_px = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    x = (corners_px[:, 0] - K[0, 2]) * depth / K[0, 0]
    y = (corners_px[:, 1] - K[1, 2]) * depth / K[1, 1]
    cam = np.stack([x, y, np.full(4, depth)], axis=1)
    pts = np.concatenate([np.zeros((1, 3)), cam], axis=0)
    pts = pts @ np.asarray(c2w, np.float64)[:3, :3].T + \
        np.asarray(c2w, np.float64)[:3, 3]
    lines = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                      [1, 2], [2, 3], [3, 4], [4, 1]], np.int32)
    return pts, lines


def export_frustum_lineset(path, c2w: np.ndarray, K: np.ndarray,
                           hw: Tuple[int, int], depth: float = 0.3,
                           samples_per_edge: int = 24) -> None:
    """Headless frustum export: edge-sampled points as a PLY (same style
    as export_obb_lineset)."""
    pts, lines = camera_frustum_lineset(c2w, K, hw, depth)
    t = np.linspace(0.0, 1.0, samples_per_edge)[:, None]
    seg = [pts[a][None] * (1 - t) + pts[b][None] * t for a, b in lines]
    samples = np.concatenate(seg, axis=0)
    colors = np.tile(np.array([[255, 64, 64]], np.uint8),
                     (len(samples), 1))
    write_ply(path, samples.astype(np.float32), colors)


def stream_pcd(queue, conn, flag, output_dir, show: bool = False,
               queries: Optional[Sequence[str]] = None, cam=None) -> None:
    """Viewer-process target (the reference's visualizer.py:324-393 stream
    loop + :146-162 query handshake). Consumes (points, obj_ids, colors) frames
    from ``queue`` until a ``None`` sentinel. Headless mode: optionally
    issues scripted ``queries`` through the cross-process protocol
    (conn.send(query); flag=1 -> wait flag=2 -> conn.recv(per-point sims))
    and exports colored PLY snapshots of the final map.

    ``cam``: optional (K 3x3, H, W) -- with it, stream items may carry a
    4th element (the current c2w) and the viewer draws/export the camera
    frustum lineset (the reference's visualizer.py frustum updates).

    With open3d installed the same loop drives a live window instead.
    """
    try:
        _stream_pcd(queue, conn, flag, output_dir, show, queries, cam)
    except Exception:  # noqa: BLE001 -- subprocess: leave a diagnosable trace
        import traceback

        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "viewer_err.txt").write_text(traceback.format_exc())
        raise


def _stream_pcd(queue, conn, flag, output_dir, show: bool = False,
                queries: Optional[Sequence[str]] = None, cam=None) -> None:
    import multiprocessing
    import time
    from queue import Empty

    # the mapper's process: if it dies without its sentinel, the viewer
    # exports what arrived instead of waiting for ever
    mapper = multiprocessing.parent_process()
    queries = list(queries or [])
    latest = None
    last_pose = None
    out = Path(output_dir)
    vis_window = None
    frustum_geom = None
    if show and _has_o3d():
        import open3d as o3d

        vis_window = o3d.visualization.Visualizer()
        vis_window.create_window()
        pcd_geom = o3d.geometry.PointCloud()

    n_frames = 0
    query_results = []
    while True:
        try:
            item = queue.get(timeout=1.0)
        except Empty:
            if mapper is not None and not mapper.is_alive():
                break
            continue
        if item is None:
            break
        latest = item[:3]
        if len(item) > 3 and item[3] is not None:
            last_pose = np.asarray(item[3], np.float64)
        n_frames += 1
        if vis_window is not None:
            import open3d as o3d

            pts, obj_ids, _ = latest
            pcd_geom.points = o3d.utility.Vector3dVector(
                np.asarray(pts, np.float64))
            pcd_geom.colors = o3d.utility.Vector3dVector(
                instance_colors(np.asarray(obj_ids)).astype(np.float64)
                / 255.0)
            if n_frames == 1:
                vis_window.add_geometry(pcd_geom)
            vis_window.update_geometry(pcd_geom)
            if last_pose is not None and cam is not None:
                K, h, w = cam
                fpts, flines = camera_frustum_lineset(last_pose,
                                                      np.asarray(K), (h, w))
                if frustum_geom is None:
                    frustum_geom = o3d.geometry.LineSet()
                    frustum_geom.lines = o3d.utility.Vector2iVector(flines)
                    frustum_geom.paint_uniform_color([1.0, 0.25, 0.25])
                frustum_geom.points = o3d.utility.Vector3dVector(fpts)
                if n_frames == 1:
                    vis_window.add_geometry(frustum_geom)
                vis_window.update_geometry(frustum_geom)
            vis_window.poll_events()
            vis_window.update_renderer()
        if queries:
            q = queries.pop(0)
            # drain any stale reply from a previously timed-out query so a
            # late mapper answer is never attributed to this query
            while conn.poll(0):
                conn.recv()
            conn.send(q)
            with flag.get_lock():
                flag.value = 1
            t0 = time.time()
            while time.time() - t0 < 60.0:
                with flag.get_lock():
                    done = flag.value == 2
                if done:
                    break
                time.sleep(0.005)
            if done and conn.poll(5.0):
                vals = conn.recv()
                query_results.append((q, np.asarray(vals)))
            with flag.get_lock():
                flag.value = 0

    if latest is not None:
        pts, obj_ids, colors = latest
        export_colored_pcd(out, pts, obj_ids, colors, tag="stream_final")
        for q, vals in query_results:
            export_colored_pcd(out, pts, obj_ids, query_values=vals,
                               tag=f"stream_query_{q.replace(' ', '_')}")
        if last_pose is not None and cam is not None:
            K, h, w = cam
            out.mkdir(parents=True, exist_ok=True)
            export_frustum_lineset(out / "stream_frustum.ply", last_pose,
                                   np.asarray(K), (h, w))
    if vis_window is not None:
        vis_window.destroy_window()


class Visualizer:
    """Interactive (open3d) or headless-export viewer over a finished run."""

    def __init__(self, semantic_mapper=None, output_dir: str = "vis_out"):
        self.ovo = semantic_mapper
        self.output_dir = Path(output_dir)

    def query_values_per_point(self, obj_ids: np.ndarray, query: str
                               ) -> np.ndarray:
        sim = self.ovo.query([query])[:, 0]
        ids = self.ovo.active_ids()
        lut = np.zeros(int(ids.max()) + 2 if len(ids) else 1, np.float32)
        lut[ids] = np.clip(sim, 0.0, 1.0)
        vals = np.where(obj_ids >= 0,
                        lut[np.clip(obj_ids, 0, len(lut) - 1)], 0.0)
        return vals

    def visualize_and_query(self, points, obj_ids, colors=None,
                            queries: Optional[Sequence[str]] = None,
                            show_obbs: bool = False,
                            interactive: bool = False) -> None:
        """``interactive=True`` requests the GUI query app explicitly
        (reference --visualize_interactive_query); without open3d it
        degrades to the headless PLY exports with a warning."""
        points = np.asarray(points)
        obj_ids = np.asarray(obj_ids).reshape(-1)
        if show_obbs:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            export_obb_lineset(self.output_dir / "map_obbs.ply",
                               instance_obbs(points, obj_ids))
        if interactive and not _has_o3d():
            print("[viz] --visualize_interactive_query requested but open3d "
                  "is unavailable; falling back to headless PLY exports")
        if not _has_o3d():
            export_colored_pcd(self.output_dir, points, obj_ids, colors)
            for q in queries or []:
                vals = self.query_values_per_point(obj_ids, q)
                export_colored_pcd(self.output_dir, points, obj_ids,
                                   query_values=vals,
                                   tag=f"query_{q.replace(' ', '_')}")
            print(f"[viz] open3d unavailable; wrote PLY snapshots to "
                  f"{self.output_dir}")
            return
        app = InteractiveViewer(self, points, obj_ids, colors,
                                output_dir=self.output_dir)
        app.run()


class InteractiveViewer:
    """Open3D GUI query app over a finished run (reference
    visualizer.py:16-399 surface): an O3DVisualizer window plus a widget
    panel with a text query box, similarity-threshold slider,
    instance/RGB color toggle, hide-ceiling toggle, reset button, and
    snapshot / camera-pose persistence actions. Queries run against the
    live SemanticMapper and recolor the cloud as a heatmap above the
    threshold.

    Only constructed when open3d is importable; `Visualizer` degrades to
    the headless PLY exports otherwise. No machine the port runs on has
    open3d, so this class has run nowhere (ROADMAP.md)."""

    def __init__(self, viz: "Visualizer", points, obj_ids, colors,
                 output_dir: Path):
        import open3d as o3d
        import open3d.visualization.gui as gui

        self.o3d, self.gui = o3d, gui
        self.viz = viz
        self.points = np.asarray(points, np.float64)
        self.obj_ids = np.asarray(obj_ids).reshape(-1)
        self.rgb = (np.asarray(colors, np.float64) / 255.0
                    if colors is not None else None)
        self.inst_rgb = instance_colors(self.obj_ids).astype(np.float64) / 255
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.th = 0.5
        self.query = ""
        self.show_instances = self.rgb is None
        self.hide_ceiling = False
        self._query_vals = None
        self._n_snap = 0
        # ceiling = points above the 95th height percentile (gravity -y:
        # smallest y values in camera-up convention)
        y = self.points[:, 1]
        self._ceiling_mask = y < np.percentile(y, 5.0)

        app = gui.Application.instance
        app.initialize()
        self.app = app
        self.win = o3d.visualization.O3DVisualizer("ovo-tpu viewer",
                                                   1280, 720)
        self.win.add_action("Take snapshot", self._take_snapshot)
        self.win.add_action("Save cam pose", self._save_campose)
        self.win.add_action("Load cam pose", self._load_campose)
        app.add_window(self.win)
        self._build_widgets()
        self._refresh()

    # -- widget panel (reference create_widgets_window) ------------------
    def _build_widgets(self) -> None:
        gui = self.gui
        w = gui.Application.instance.create_window("Query options", 420, 170)
        em = w.theme.font_size
        layout = gui.Vert(0, gui.Margins(*([0.5 * em] * 4)))

        self._query_in = gui.TextEdit()
        self._query_in.set_on_value_changed(self._on_query_text)
        btn = gui.Button("Update query")
        btn.set_on_clicked(self._on_update)
        btn.vertical_padding_em = 0
        row = gui.Horiz()
        row.add_child(gui.Label("Query: "))
        row.add_child(self._query_in)
        row.add_fixed(0.25 * em)
        row.add_child(btn)
        layout.add_child(row)

        sl = gui.Slider(gui.Slider.DOUBLE)
        sl.set_limits(0.0, 1.0)
        sl.double_value = self.th
        sl.set_on_value_changed(self._on_th)
        row2 = gui.Horiz()
        row2.add_child(gui.Label("Similarity th: "))
        row2.add_child(sl)
        layout.add_child(row2)

        cb = gui.Checkbox("Show object instances")
        cb.checked = self.show_instances
        cb.set_on_checked(self._on_instances)
        layout.add_child(cb)

        cbc = gui.Checkbox("Hide ceiling")
        cbc.checked = self.hide_ceiling
        cbc.set_on_checked(self._on_ceiling)
        layout.add_child(cbc)

        rst = gui.Button("Reset vis")
        rst.vertical_padding_em = 0
        rst.set_on_clicked(self._on_reset)
        layout.add_child(rst)
        w.add_child(layout)

    # -- callbacks -------------------------------------------------------
    def _on_query_text(self, text):
        self.query = str(text)

    def _on_th(self, value):
        self.th = float(value)
        self._refresh()

    def _on_update(self):
        if self.query and self.viz.ovo is not None:
            self._query_vals = self.viz.query_values_per_point(
                self.obj_ids, self.query)
        self._refresh()

    def _on_instances(self, checked):
        self.show_instances = bool(checked)
        self._refresh()

    def _on_ceiling(self, checked):
        self.hide_ceiling = bool(checked)
        self._refresh()

    def _on_reset(self):
        self._query_vals = None
        self._query_in.text_value = ""
        self.query = ""
        self._refresh()

    def _take_snapshot(self, vis=None):
        path = str(self.output_dir / f"snapshot_{self._n_snap:03d}.png")
        self._n_snap += 1
        self.win.export_current_image(path)

    def _save_campose(self, vis=None):
        import json

        cam = self.win.scene.camera
        mat = np.asarray(cam.get_model_matrix()).tolist()
        with open(self.output_dir / "campose.json", "w") as f:
            json.dump(mat, f)

    def _load_campose(self, vis=None):
        import json

        p = self.output_dir / "campose.json"
        if not p.exists():
            return
        mat = np.asarray(json.load(open(p)), np.float32)
        self.win.scene.camera.set_model_matrix(mat)

    # -- drawing ---------------------------------------------------------
    def _current_colors(self) -> np.ndarray:
        if self._query_vals is not None:
            return heatmap_colors(self._query_vals,
                                  self.th).astype(np.float64) / 255.0
        if self.show_instances or self.rgb is None:
            return self.inst_rgb
        return self.rgb

    def _refresh(self) -> None:
        o3d = self.o3d
        keep = (~self._ceiling_mask if self.hide_ceiling
                else np.ones(len(self.points), bool))
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(self.points[keep])
        pcd.colors = o3d.utility.Vector3dVector(
            self._current_colors()[keep])
        self.win.remove_geometry("pcd")
        self.win.add_geometry("pcd", pcd)

    def run(self) -> None:
        self.app.run()
