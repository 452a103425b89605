"""OVOSemMap pipeline orchestrator (port of
``ovo_tpu/mapping/pipeline.py``).

The per-frame loop with track / map / segment cadences, deferred-CLIP
draining, the reference's fps / spf / memory stat names, and the two-part
``ovo_map.ckpt`` checkpoint. Frames are read by a prefetch thread (one
producer, one consumer) so dataset reads overlap device work.

The dataset is built from the config (``data/datasets.get_dataset`` of
``dataset_name`` over the ``data`` and ``cam`` sections) unless the caller
passes one (duck-typed: ``__getitem__`` -> (id, image u8 (H, W, 3), depth
f32 (H, W), c2w (4, 4)), ``__len__``, ``intrinsics``, ``height``,
``width``).

``restore_map`` resumes a run from its checkpoint (vanilla backbone only):
the semantic state, the map and the poses are restored and the run starts
after the last restored pose. ``profile_trace`` (a directory) traces the
reference's step window -- from the first segment step, for
``profile_trace_steps`` (default 3) more steps, or to the end of the run --
with ``torch.profiler`` (CUDA activity on the card, CPU activity on the
CPU) and writes a Chrome trace there: PyTorch's format, where the JAX
package writes ``jax.profiler``'s, with the program's spans and counters
of the window (``utils/trace.py``) on a process track of their own.

Backbones: ``vanilla`` (GT poses), ``orbslam*`` (the native tracker's
poses, mapping on its keyframes) and ``gaussian_slam`` (poses by rendering
a gaussian map, ``slam/gaussian``); when a backbone reports a big change
after mapping a frame, the semantic map follows it through
``SemanticMapper.update_map`` and the seconds it took count in the
frame's ``spf``.

The viewer stream (``vis.stream``, or ``enable_stream``): after each
segment step the map's live rows go to a viewer process
(``viz/visualizer.stream_pcd``) through a queue, and the mapper answers its
text queries through a pipe and a shared flag (the reference's
handshake). Each streamed frame reads the map to the host
(:func:`stream_rows`), each answered query its instance ids
(:func:`live_obj_ids`).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device
from ..slam import get_slam_backbone
from ..utils import io as io_utils
from ..utils import trace
from ..utils.logging import Logger
from .map_state import MapState
from .semantic import SemanticMapper


def stream_rows(state: MapState) -> tuple:
    """The map's live rows on the host for the viewer stream: (points,
    obj_ids, colors) numpy arrays. The host reads of a streamed frame (the
    count, then three copies), as the reference's ``np.asarray`` makes."""
    n = int(state.count)
    return (state.points[:n].cpu().numpy(), state.obj_ids[:n].cpu().numpy(),
            state.colors[:n].cpu().numpy())


def live_obj_ids(state: MapState) -> np.ndarray:
    """The map's live instance ids on the host, all that a streamed query
    reads of the map (the count, then one copy), as the reference reads
    ``state.obj_ids[:n]``."""
    return state.obj_ids[:int(state.count)].cpu().numpy()


class OVOSemMap:
    def __init__(self, config: Dict[str, Any], output_path,
                 mask_source=None, embedder=None, dataset=None,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # metric geometry and the resize matmuls are f32: no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.output_path = Path(output_path)
        self.output_path.mkdir(exist_ok=True, parents=True)
        io_utils.save_dict_to_yaml(config, "config.yaml",
                                   directory=self.output_path)
        config["output_path"] = str(self.output_path)
        config.setdefault("semantic", {})["debug_info"] = \
            config.get("debug_info", False)
        self.config = config

        self.map_every = config["mapping"].get("map_every", 10)
        self.segment_every = config["semantic"].get("segment_every", 10)
        tracking = config.get("tracking") or {}
        self.track_every = tracking.get("track_every", 1)

        self.logger = Logger(self.output_path, device=self.device,
                             use_wandb=config.get("use_wandb", False))
        if dataset is None:
            from ..data.datasets import get_dataset

            dataset = get_dataset(config["dataset_name"])(
                {**config["data"], **config["cam"]})
        self.dataset = dataset
        cam_intrinsics = np.asarray(self.dataset.intrinsics, np.float32)
        if mask_source is None or embedder is None:
            from ..factory import build_embedder, build_mask_source

            mask_source = mask_source or build_mask_source(
                config["semantic"], config["data"].get("scene_name"),
                device=self.device)
            embedder = embedder or build_embedder(config["semantic"],
                                                  device=self.device)
        sam_cfg = config["semantic"].get("sam", {})
        if sam_cfg.get("precompute", False) and not sam_cfg.get(
                "precomputed", False):
            mask_source = self._precompute_masks(mask_source, sam_cfg)

        self.ovo = SemanticMapper(config["semantic"], self.logger,
                                  config["data"].get("scene_name"),
                                  cam_intrinsics, mask_source=mask_source,
                                  embedder=embedder, device=self.device)
        self.slam_backbone = get_slam_backbone(config, self.dataset,
                                               cam_intrinsics, self.device)
        self.profile_trace = config.get("profile_trace")
        self.profile_trace_steps = int(config.get("profile_trace_steps", 3))
        self._trace_state = 0  # 0 idle, > 0 steps traced, -1 done
        self._profiler = None
        vis_cfg = config.get("vis") or {}
        self.stream = bool(vis_cfg.get("stream", False))
        self.show_stream = bool(vis_cfg.get("show_stream", False))
        self.pcd_queue = None
        self.query_pipe = None
        self.query_flag = None
        self.viewer_proc = None
        self._stream_has_queries = False
        self.first_frame = 0
        if config.get("restore_map", False):
            if config["slam"].get("slam_module", "vanilla") != "vanilla":
                raise ValueError("restoring a representation is implemented "
                                 "for the 'vanilla' backbone only")
            self.restore_representation()
            self.first_frame = max(self.slam_backbone.estimated_c2ws) + 1

    # ------------------------------------------------------------------
    def _precompute_masks(self, mask_source, sam_cfg):
        """Segment every segment-cadence frame once, save the reference's
        npy masks, then run from disk."""
        from ..data.masks import PrecomputedMaskSource

        scene = self.config["data"].get("scene_name", "scene")
        base = sam_cfg.get("masks_base_path",
                           str(self.output_path / "masks"))
        store = PrecomputedMaskSource(
            os.path.join(base, scene) if scene not in base else base,
            max_masks=self.config["semantic"].get(
                "capacity", {}).get("n_masks", 96), device=self.device)
        for fid in range(0, len(self.dataset), self.segment_every):
            fd = self.dataset[fid]
            image = fd[4] if len(fd) == 5 else fd[1]
            seg, bmaps, valid = mask_source.get_masks(image, fid)
            if seg is None:
                continue
            n = int(valid.sum())
            store.save_masks(seg.cpu().numpy(), bmaps[:n].cpu().numpy(), fid)
        print(f"[ovo_tpu_torch] precomputed masks for "
              f"{len(range(0, len(self.dataset), self.segment_every))} "
              f"frames -> {store.masks_path}")
        return store

    # ------------------------------------------------------------------
    def save_representation(self) -> None:
        map_params = self.slam_backbone.get_map_dict()
        ckpt = {
            "map_params": map_params,
            "ovo_map_params": self.ovo.capture_dict(
                debug_info=self.config.get("debug", False),
                map_dict=map_params),
        }
        io_utils.save_dict_to_ckpt(ckpt, "ovo_map.ckpt",
                                   directory=self.output_path)
        if self.config["slam"].get("save_estimated_cam", False):
            np.save(self.output_path / "estimated_c2w.npy",
                    self.slam_backbone.get_cam_dict(), allow_pickle=True)

    def restore_representation(self) -> None:
        """The checkpoint of a previous run in ``output_path``: semantic
        state (with its debug records when ``debug`` is set), map and, when
        saved, the camera poses."""
        ckpt_path = self.output_path / "ovo_map.ckpt"
        if not ckpt_path.exists():
            raise FileNotFoundError(f"Missing checkpoint: {ckpt_path}")
        ckpt = io_utils.load_ckpt(ckpt_path)
        self.ovo.restore_dict(ckpt["ovo_map_params"],
                              debug_info=self.config.get("debug", False))
        self.slam_backbone.set_map_dict(ckpt["map_params"])
        c2w_path = self.output_path / "estimated_c2w.npy"
        if c2w_path.exists():
            self.slam_backbone.set_cam_dict(
                np.load(c2w_path, allow_pickle=True).item())
        else:
            print(f"Missing cameras positions to restore: {c2w_path}")
            print("Restoring without camera positions!")

    # ------------------------------------------------------------------
    def enable_stream(self, spawn_process: bool = True, queries=None):
        """Set up the viewer stream. With ``spawn_process`` a separate OS
        process runs ``viz.visualizer.stream_pcd`` (headless it exports
        snapshots and can issue scripted ``queries``); without, the caller
        gets the viewer-side handles (queue, conn, flag) to drive the
        handshake directly."""
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._stream_has_queries = bool(queries)
        self.pcd_queue = ctx.Queue()
        self.query_flag = ctx.Value("i", 0)
        parent_conn, child_conn = ctx.Pipe()
        self.query_pipe = parent_conn
        if not spawn_process:
            return self.pcd_queue, child_conn, self.query_flag
        from ..viz.visualizer import stream_pcd

        cam = self.config.get("cam", {})
        cam_arg = None
        if {"fx", "fy", "cx", "cy", "H", "W"} <= set(cam):
            K = np.array([[cam["fx"], 0, cam["cx"]],
                          [0, cam["fy"], cam["cy"]],
                          [0, 0, 1]], np.float64)
            cam_arg = (K, int(cam["H"]), int(cam["W"]))
        # a daemon: a run that raises does not wait at exit for a viewer
        # still blocked on the queue
        self.viewer_proc = ctx.Process(
            target=stream_pcd,
            args=(self.pcd_queue, child_conn, self.query_flag,
                  str(self.output_path / "stream_out"), self.show_stream,
                  queries, cam_arg), daemon=True)
        self.viewer_proc.start()
        return None

    def _stream_frame(self, c2w=None) -> None:
        self.pcd_queue.put(stream_rows(self.slam_backbone.get_map())
                           + (None if c2w is None else np.asarray(c2w),))

    def _serve_stream_query(self, timeout: float = 30.0) -> None:
        """Mapper side of the query round trip: flag 1 -> receive the
        query, drain the deferred descriptors, flag 2, send the per-point
        similarities back."""
        with self.query_flag.get_lock():
            pending = self.query_flag.value == 1
        if not pending or not self.query_pipe.poll(timeout):
            return
        query = self.query_pipe.recv()
        if self.ovo._pending:
            # sam.batch > 1: buffered keyframes are segmented and associated
            # first, or their instances would be missing from the answer
            new_state = self.ovo.flush_segmentation(
                self.slam_backbone.get_map())
            if new_state is not None:
                self.slam_backbone.update_pcd_obj_ids(new_state)
        self.ovo.complete_semantic_info()
        obj_ids = live_obj_ids(self.slam_backbone.get_map())
        from ..viz.visualizer import Visualizer

        vals = Visualizer(self.ovo).query_values_per_point(obj_ids, query)
        # the flag goes to 2 before the values are sent (the reference sends
        # first): a map's values overfill the pipe's buffer, the send then
        # blocks until the viewer reads, and the viewer reads only once it
        # sees the flag
        with self.query_flag.get_lock():
            self.query_flag.value = 2
        self.query_pipe.send(vals)

    def _close_stream(self) -> None:
        if self.pcd_queue is not None:
            # grace period: the viewer may not have taken the last frame, or
            # may have a query in flight
            t0 = time.time()
            while time.time() - t0 < 5.0:
                self._serve_stream_query(timeout=0.05)
                try:
                    drained = self.pcd_queue.qsize() == 0
                except NotImplementedError:  # macOS
                    drained = True
                with self.query_flag.get_lock():
                    idle = self.query_flag.value == 0
                if drained and idle:
                    break
                time.sleep(0.02)
            self.pcd_queue.put(None)
        if self.viewer_proc is not None:
            # keep answering while waiting: a slow viewer may issue its
            # scripted queries only after the run ended, and an unanswered
            # flag 1 stalls it for its whole per-query timeout before it
            # writes the final exports. Without scripted queries a wedged
            # viewer delays the exit 30 s at most.
            cap = 300 if self._stream_has_queries else 30
            t0 = time.time()
            while self.viewer_proc.is_alive() and time.time() - t0 < cap:
                self._serve_stream_query(timeout=0.05)
                self.viewer_proc.join(timeout=0.5)
            if self.viewer_proc.is_alive():
                self.viewer_proc.terminate()
                self.viewer_proc.join()
            self.viewer_proc = None
        elif self.pcd_queue is not None:
            # no consumer: the queue's feeder thread would block the
            # interpreter's exit on unflushed frames
            self.pcd_queue.cancel_join_thread()

    # ------------------------------------------------------------------
    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activity = (ProfilerActivity.CUDA if self.device.type == "cuda"
                    else ProfilerActivity.CPU)
        self._profiler = profile(activities=[activity])
        self._profiler.start()

    def _stop_trace(self) -> None:
        self._profiler.stop()
        out = Path(self.profile_trace)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{time.strftime('%Y_%m_%d_%H_%M_%S')}.pt.trace.json"
        self._profiler.export_chrome_trace(str(path))
        # the program's spans and counters of the window, on the same clock
        trace.export_chrome(path)
        self._profiler = None
        self._trace_state = -1

    # ------------------------------------------------------------------
    def _frame_schedule(self):
        return [fid for fid in range(self.first_frame, len(self.dataset))
                if (self.track_every == 1 or fid % self.track_every == 0
                    or fid % self.map_every == 0
                    or fid % self.segment_every == 0)]

    def run(self) -> None:
        if self.stream and self.pcd_queue is None:
            self.enable_stream(spawn_process=True)
        spf = []
        t_start = time.time()
        schedule = self._frame_schedule()
        prefetch: queue.Queue = queue.Queue(maxsize=4)
        stop = threading.Event()

        def _producer():
            try:
                for fid in schedule:
                    if stop.is_set():
                        return
                    with trace.span("data.read", fid):
                        item = self.dataset[fid]
                    prefetch.put((fid, item))
            except BaseException as exc:  # noqa: BLE001 -- re-raised below
                prefetch.put(exc)
                return
            prefetch.put(None)

        producer = threading.Thread(target=_producer, daemon=True)
        producer.start()
        try:
            while True:
                with trace.span("loop.data_wait"):
                    item = prefetch.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                spf_t = self._step(*item)
                if spf_t > 0:
                    spf.append(spf_t)
        finally:
            stop.set()
            while producer.is_alive():
                try:
                    prefetch.get(timeout=0.1)
                except queue.Empty:
                    pass

        if self._trace_state > 0:
            self._stop_trace()
        with trace.span("run.tail"):
            self._run_tail(t_start, spf)
        self.save_representation()

    def _run_tail(self, t_start: float, spf) -> None:
        """After the frame loop: the last flush and descriptors, the
        stream's close and the run's stats."""
        if self.ovo._pending:
            # sam.batch > 1: segment and associate the buffered keyframes
            new_state = self.ovo.flush_segmentation(
                self.slam_backbone.get_map())
            if new_state is not None:
                self.slam_backbone.update_pcd_obj_ids(new_state)
        self.ovo.complete_semantic_info()
        self._close_stream()
        t_end = time.time()
        fps = len(self.dataset) / self.segment_every / (t_end - t_start)
        self.logger.log_fps(fps)
        self.logger.log_spf(spf)
        self.logger.log_max_memory_usage()
        dropped = self.ovo.n_dropped_masks_total()
        if dropped:
            print(f"WARNING: {dropped} masks were dropped at instance "
                  f"capacity over the whole scene")
            self.logger.log_ovo_stats({"frame_id": -1,
                                       "n_dropped_masks": dropped})
        self.logger.write_stats()
        self.logger.print_final_stats()

    def _step(self, frame_id: int, frame_data) -> float:
        """One scheduled frame; returns its semantic seconds (0 if none)."""
        with trace.span("step", frame_id):
            with trace.span("backbone.track"):
                self.slam_backbone.track_camera(frame_data)
            c2w = self.slam_backbone.get_c2w(frame_id)
            if c2w is None or not (frame_data[2] > 0).any():
                return 0.0
            slam_module = self.config["slam"]["slam_module"]
            # the ORB tier decides on every frame whether it maps (its
            # tracker's keyframes)
            do_map = (frame_id % self.map_every == 0
                      or slam_module.startswith("orbslam"))
            do_seg = frame_id % self.segment_every == 0
            # mapping on the segment cadence fuses the vanilla insert into the
            # association (one pass, shared projection and gathers)
            fuse_this = (do_map and do_seg and slam_module == "vanilla"
                         and self.slam_backbone.supports_fused_insert
                         and self.ovo.sam_batch == 1
                         and not self.ovo.point_shard)
            t_lc = 0.0
            if do_map and not fuse_this:
                self.slam_backbone.map(frame_data, c2w)
                if self.slam_backbone.map_updated:
                    t_lc = self._loop_closure()
            if not do_seg:
                return t_lc
            if self.profile_trace and self._trace_state == 0:
                self._start_trace()
            t0 = time.time()
            image = frame_data[4] if len(frame_data) == 5 else frame_data[1]
            if (self.dataset.height != image.shape[0]
                    or self.dataset.width != image.shape[1]):
                ratio = (image.shape[0] / self.dataset.dataset_config["H"],
                         image.shape[1] / self.dataset.dataset_config["W"],
                         self.dataset.crop_edge)
            else:
                ratio = ()
            scene_data = (frame_id, image, frame_data[2], ratio)
            if fuse_this:
                # growth first (it may swap the state buffers), then the handle
                insert = self.slam_backbone.fused_insert_args(frame_data)
                new_state = self.ovo.detect_and_track_objects(
                    scene_data, self.slam_backbone.get_map(), c2w,
                    insert=insert)
                if new_state is None:
                    # no masks segmented: the frame must still map
                    self.slam_backbone.map(frame_data, c2w)
                else:
                    self.slam_backbone.update_pcd_obj_ids(new_state)
                    self.slam_backbone.post_insert()
            else:
                new_state = self.ovo.detect_and_track_objects(
                    scene_data, self.slam_backbone.get_map(), c2w)
                if new_state is not None:
                    self.slam_backbone.update_pcd_obj_ids(new_state)
            with trace.span("semantic_info"):
                self.ovo.compute_semantic_info()
            with trace.span("logger.memory"):
                self.logger.log_memory_usage(frame_id)
            t_sem = time.time() - t0
            if self.pcd_queue is not None:
                self._stream_frame(c2w)
                self._serve_stream_query()
            if self.profile_trace and self._trace_state >= 0:
                self._trace_state += 1
                if self._trace_state > self.profile_trace_steps:
                    self._stop_trace()
            return t_sem + t_lc

    def _loop_closure(self) -> float:
        """The backbone rebuilt its map (a SLAM big change): the semantic
        map follows (``SemanticMapper.update_map``). Returns its seconds."""
        t0 = time.time()
        new_state = self.ovo.update_map(self.slam_backbone.get_map(),
                                        self.slam_backbone.get_kfs())
        if new_state is not None:
            self.slam_backbone.update_pcd_obj_ids(new_state)
        self.slam_backbone.map_updated = False
        t_lc = time.time() - t0
        print(f"Sem LC update took {t_lc};")
        return t_lc
