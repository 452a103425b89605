"""The port's viewer (``ovo_tpu_torch/viz``, the pipeline's stream and
``ovo_tpu_torch.visualize_scene``) against the JAX package's: the query
handshake on the protocol of ``tests/test_stream_viewer.py`` (mapper side
driven directly, then a spawned headless viewer), the frustum lineset's
arrays, PLY bytes, the viridis heatmap colours against matplotlib's
``cm.viridis`` (through the reference's ``heatmap_colors``), and the
headless ``visualize_scene`` exports of a finished port run next to the
reference script's on the same run. Arrays and bytes are compared exactly.
"""
import queue as queue_mod
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ovo_tpu.viz import visualizer as jviz

from ovo_tpu_torch.data.masks import CallableMaskSource, RecordedEmbedder
from ovo_tpu_torch.mapping.pipeline import OVOSemMap
from ovo_tpu_torch.viz import visualizer as tviz

from synthetic_scene import (CLASSES, SyntheticWallDataset, class_embeddings,
                             mask_label_fn, synthetic_mask_fn)

ROOT = Path(__file__).resolve().parents[1]


def make_pipeline(tmp_path, stream=False, sam_batch=1):
    """tests/test_stream_viewer.py's pipeline, in the port on the CPU."""
    config = {
        "dataset_name": "synthetic", "use_wandb": False, "debug": False,
        "slam": {"slam_module": "vanilla", "save_estimated_cam": False},
        "mapping": {"map_every": 2, "k_pooling": 1, "downscale_res": 1,
                    "n_points_capacity": 1 << 16},
        "tracking": {"track_every": 1},
        "vis": {"stream": stream},
        "data": {"scene_name": "wall0"},
        "cam": {"fx": 80.0, "fy": 80.0, "cx": 47.5, "cy": 31.5,
                "H": 64, "W": 96},
        "semantic": {
            "segment_every": 2, "match_distance_th": 0.05, "track_th": 40,
            "depth_filter": False, "log": False, "kf_queue_delay": 1,
            "capacity": {"n_instances": 64, "n_masks": 16},
            "sam": {"batch": sam_batch},
            "clip": {"k_top_views": 10000, "fusion": "avg_pooling",
                     "clip_dim": 16},
        },
    }
    embeds = class_embeddings(16)
    text_embeds = {c: embeds[i] for i, c in enumerate(CLASSES)}
    return OVOSemMap(
        config, tmp_path,
        mask_source=CallableMaskSource(synthetic_mask_fn, 16, "cpu"),
        embedder=RecordedEmbedder(16, mask_label_fn, embeds, text_embeds,
                                  device="cpu"),
        dataset=SyntheticWallDataset(n_frames=10), device="cpu")


def _drain(q, want=3, deadline_s=30.0):
    frames = []
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        try:
            item = q.get(timeout=0.5)
        except queue_mod.Empty:
            if len(frames) >= want:
                break
            continue
        if item is not None:
            frames.append(item)
    return frames


def test_query_handshake_mapper_side(tmp_path):
    """flag 1 + a query on the pipe -> per-point similarities back, flag 2;
    the streamed frames are the map's live rows with the camera pose."""
    sem_map = make_pipeline(tmp_path)
    q, viewer_conn, flag = sem_map.enable_stream(spawn_process=False)
    sem_map.run()
    frames = _drain(q)
    assert len(frames) == 5                       # one per segment step
    pts, obj_ids, colors, c2w = frames[-1]
    state = sem_map.slam_backbone.get_map()
    n = int(state.count)
    np.testing.assert_array_equal(pts, state.points[:n].numpy())
    np.testing.assert_array_equal(obj_ids, state.obj_ids[:n].numpy())
    np.testing.assert_array_equal(colors, state.colors[:n].numpy())
    np.testing.assert_array_equal(c2w, sem_map.dataset[8][3])
    viewer_conn.send("chair")
    with flag.get_lock():
        flag.value = 1
    sem_map._serve_stream_query(timeout=5.0)
    with flag.get_lock():
        assert flag.value == 2
    vals = viewer_conn.recv()
    assert vals.shape[0] == n
    assert vals.max() > 0.9
    np.testing.assert_array_equal(
        vals, tviz.Visualizer(sem_map.ovo).query_values_per_point(
            obj_ids, "chair"))


def test_stream_viewer_process_roundtrip(tmp_path):
    """The spawned headless viewer consumes the frames, issues its scripted
    queries and exports the final snapshots; the final instance cloud is
    the final map's, byte for byte."""
    sem_map = make_pipeline(tmp_path)
    sem_map.enable_stream(spawn_process=True, queries=["chair", "table"])
    sem_map.run()
    assert sem_map.viewer_proc is None
    out = tmp_path / "stream_out"
    for name in ("stream_final_instances.ply", "stream_final_rgb.ply",
                 "stream_query_chair_query.ply",
                 "stream_query_table_query.ply", "stream_frustum.ply"):
        assert (out / name).exists(), name
    state = sem_map.slam_backbone.get_map()
    n = int(state.count)
    tviz.write_ply(tmp_path / "final.ply", state.points[:n].numpy(),
                   tviz.instance_colors(state.obj_ids[:n].numpy()))
    assert (out / "stream_final_instances.ply").read_bytes() == \
        (tmp_path / "final.ply").read_bytes()


def test_stream_from_config_with_batched_masks(tmp_path):
    """``vis.stream: true`` spawns the viewer from the config; with
    ``sam.batch: 2`` a query first flushes the buffered keyframes."""
    sem_map = make_pipeline(tmp_path, stream=True, sam_batch=2)
    sem_map.run()
    assert (tmp_path / "stream_out" / "stream_final_instances.ply").exists()
    assert sem_map.pcd_queue is not None and sem_map.viewer_proc is None


def test_camera_frustum_lineset_matches_reference():
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, :3] = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    c2w[:3, 3] = [1.0, 2.0, 3.0]
    for depth in (0.3, 0.5):
        pts, lines = tviz.camera_frustum_lineset(c2w, K, (48, 64), depth)
        jpts, jlines = jviz.camera_frustum_lineset(c2w, K, (48, 64), depth)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(lines, jlines)
        assert pts.dtype == np.float64 and lines.dtype == np.int32
    np.testing.assert_allclose(pts[0], [1.0, 2.0, 3.0])


def test_ply_bytes_match_reference(tmp_path, rng):
    pts = rng.standard_normal((257, 3)).astype(np.float32)
    obj = rng.integers(-1, 30, 257)
    cols = rng.integers(0, 256, (257, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tviz.instance_colors(obj),
                                  jviz.instance_colors(obj))
    for name, c in (("inst", tviz.instance_colors(obj)), ("rgb", cols)):
        tviz.write_ply(tmp_path / f"t_{name}.ply", pts, c)
        jviz.write_ply(tmp_path / f"j_{name}.ply", pts, c)
        assert (tmp_path / f"t_{name}.ply").read_bytes() == \
            (tmp_path / f"j_{name}.ply").read_bytes()
    vals = rng.random(257).astype(np.float32)
    tviz.export_colored_pcd(tmp_path / "t", pts, obj, cols, vals)
    jviz.export_colored_pcd(tmp_path / "j", pts, obj, cols, vals)
    for name in ("map_instances.ply", "map_rgb.ply", "map_query.ply"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    obbs = tviz.instance_obbs(pts.astype(np.float64), obj)
    jobbs = jviz.instance_obbs(pts.astype(np.float64), obj)
    assert sorted(obbs) == sorted(jobbs) and obbs
    tviz.export_obb_lineset(tmp_path / "t_obb.ply", obbs)
    jviz.export_obb_lineset(tmp_path / "j_obb.ply", jobbs)
    assert (tmp_path / "t_obb.ply").read_bytes() == \
        (tmp_path / "j_obb.ply").read_bytes()


def test_viridis_table_matches_matplotlib(rng):
    """The port's viridis constant, indexed as matplotlib indexes
    ``cm.viridis``, gives the reference's heatmap colours byte for byte:
    every table entry, the edges 0 and 1, values outside [0, 1], NaN and
    the threshold's grey."""
    import matplotlib

    assert matplotlib.__version__ == "3.10.8"
    vals = np.concatenate([
        np.arange(256) / 256.0, (np.arange(256) + 1) / 256.0 - 1e-7,
        rng.random(4096), [0.0, 1.0, -0.5, 1.5, np.nan, 0.999999, 1e-9]])
    for th in (0.0, 0.5):
        np.testing.assert_array_equal(tviz.heatmap_colors(vals, th),
                                      jviz.heatmap_colors(vals, th))
    from matplotlib import cm

    np.testing.assert_array_equal(
        tviz._VIRIDIS_U8,
        (cm.viridis(np.arange(256) / 256.0)[:, :3] * 255).astype(np.uint8))


def test_visualize_scene_headless_on_a_port_run(tmp_path, monkeypatch):
    """``python -m ovo_tpu_torch.visualize_scene`` on a finished port run
    (the CLI's ``--run --segment`` on a PNG scene): the instance and RGB
    clouds, the OBB lineset and the gt-vs-pred mesh equal the reference
    script's on the same run; a query heatmap per query."""
    sys.path[:0] = [str(ROOT)]
    import visualize_scene as jax_vis

    from replica_png_scene import write_replica_scene
    from ovo_tpu_torch import run_eval, visualize_scene

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DISABLE_WANDB", "true")
    write_replica_scene(tmp_path, "tinyroom3", 4)
    run_eval.main(run_eval.parse_args(
        "--dataset_name Replica --scenes tinyroom3 --experiment_name v "
        "--run --segment --device cpu".split()))
    scene = Path("data/output/Replica/v/tinyroom3")
    argv = [str(scene), "--working_dir", str(tmp_path), "--queries",
            "wall", "--obb", "--visualize_gt_vs_pre"]
    jax_args = visualize_scene.parse_args(argv)
    del jax_args.device
    jax_vis.main(jax_args)
    shutil.move(str(tmp_path / scene / "vis_out"), str(tmp_path / "jax_out"))
    visualize_scene.main(visualize_scene.parse_args(argv + ["--device",
                                                            "cpu"]))
    out = tmp_path / scene / "vis_out"
    for name in ("map_instances.ply", "map_rgb.ply", "map_obbs.ply",
                 "gt_vs_pred.ply"):
        assert (out / name).read_bytes() == \
            (tmp_path / "jax_out" / name).read_bytes(), name
    assert (out / "query_wall_query.ply").exists()
    ovo, map_params = run_eval.load_representation(scene, device="cpu")
    vals = tviz.Visualizer(ovo).query_values_per_point(
        np.asarray(map_params["obj_ids"]).reshape(-1), "wall")
    tviz.write_ply(tmp_path / "q.ply", np.asarray(map_params["xyz"]),
                   tviz.heatmap_colors(vals))
    assert (out / "query_wall_query.ply").read_bytes() == \
        (tmp_path / "q.ply").read_bytes()
    assert torch.is_tensor(ovo.store.clip_feature)


def test_viewer_exits_when_the_mapper_dies(tmp_path):
    """A mapper that dies without its sentinel (killed) leaves no viewer
    behind: the viewer sees its parent gone, exports what arrived and
    exits."""
    import subprocess

    code = (
        "import sys, os, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]\n"
        "from test_torch_viewer import make_pipeline\n"
        "from pathlib import Path\n"
        "if __name__ == '__main__':\n"
        f"    m = make_pipeline(Path({str(tmp_path)!r}))\n"
        "    m.enable_stream(spawn_process=True)\n"
        "    m._stream_frame()\n"
        "    print(m.viewer_proc.pid, flush=True)\n"
        "    time.sleep(1.0)\n"
        "    os._exit(3)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 3, proc.stderr[-2000:]
    pid = int(proc.stdout.split()[-1])

    def running():
        try:
            state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
        except FileNotFoundError:
            return False
        return state.split()[0] != "Z"             # a zombie has exited

    deadline = time.time() + 60
    while time.time() < deadline and running():
        time.sleep(0.2)
    assert not running()
    assert (tmp_path / "stream_out" / "stream_final_instances.ply").exists()
