"""SLAM backbone tier backed by the native C++ RGB-D tracker (port of
``ovo_tpu/slam/orbslam.py``).

Poses come from the tracker (``process_image_rgbd`` blocks the host for a
frame), the map grows only on tracker keyframes, each keyframe's point-id
range recorded, and when the tracker reports a "big change" (a loop
closure) every keyframe's block of points is moved rigidly to its
corrected pose and the blocks of culled keyframes are dropped.

The tracker is the port's own copy of the C++ source
(``ovo_tpu_torch/native/tracker/tracker.cpp``). ``g++`` builds it at first
use into ``build/ovo_tpu_torch/`` at the repo root, named by a hash of the
source, the flags and the compiler's resolved ``-march=native`` target; a
failed build raises with the compiler's log.

Host reads of the device: one per tracker keyframe, the map's count after
its insert (:func:`map_count`); a block starts where the previous one
ended. The rebuild itself (:func:`_apply_block_deltas`) reads nothing back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from .. import resolve_device, to_device
from ..mapping.map_state import MapState
from ..ops import segment_mxu
from ..ops.cuda_build import BUILD_DIR
from .vanilla import VanillaMapper

TRACKER_SOURCE = (Path(__file__).resolve().parents[1] / "native" / "tracker"
                  / "tracker.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]

# ORB-SLAM3 tracking-state codes (reference orbslam.py:43-49)
STATE_OK = 2
STATE_LOST = 3

_lib = None
_lock = threading.Lock()


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("ovo_tpu_torch: g++ not found; the native tracker "
                           "builds with a C++17 compiler")
    return cxx


def library_path() -> Path:
    """Where the tracker library of this source, these flags and this host's
    CPU target lives (a library built for another CPU is never loaded)."""
    cxx = _cxx()
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    digest = hashlib.sha256(TRACKER_SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()
                            + target.encode()).hexdigest()
    return BUILD_DIR / f"libovo_tracker-{digest[:16]}.so"


def build_library() -> Path:
    """Compile the tracker unless this build exists; raises with the
    compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                           str(TRACKER_SOURCE)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("ovo_tpu_torch: tracker build failed:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        lib.ovo_tracker_create.restype = ctypes.c_void_p
        lib.ovo_tracker_create.argtypes = [ctypes.c_double] * 3
        lib.ovo_tracker_process_image_rgbd.restype = ctypes.c_int
        lib.ovo_tracker_process_image_rgbd.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double]
        lib.ovo_tracker_get_last_trajectory_point.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        for name in ("ovo_tracker_get_tracking_state",
                     "ovo_tracker_is_last_frame_kf",
                     "ovo_tracker_get_last_big_change_idx"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.ovo_tracker_last_inlier_ratio.restype = ctypes.c_double
        lib.ovo_tracker_last_inlier_ratio.argtypes = [ctypes.c_void_p]
        lib.ovo_tracker_num_keyframes.restype = ctypes.c_int
        lib.ovo_tracker_num_keyframes.argtypes = [ctypes.c_void_p]
        lib.ovo_tracker_get_keyframe_pose.restype = ctypes.c_double
        lib.ovo_tracker_get_keyframe_pose.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        lib.ovo_tracker_keyframe_culled.restype = ctypes.c_int
        lib.ovo_tracker_keyframe_culled.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int]
        lib.ovo_tracker_set_loop_params.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double]
        lib.ovo_tracker_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeTracker:
    """ctypes facade with the reference's orbslam3 surface."""

    def __init__(self, kf_trans_th: float = 0.15, kf_rot_th: float = 0.15,
                 kf_inlier_th: float = 0.6):
        self._lib = _load_library()
        self._h = self._lib.ovo_tracker_create(kf_trans_th, kf_rot_th,
                                               kf_inlier_th)

    def process_image_rgbd(self, gray: np.ndarray, depth: np.ndarray,
                           fx, fy, cx, cy, timestamp: float = 0.0) -> int:
        gray = np.ascontiguousarray(gray, np.float32)
        depth = np.ascontiguousarray(depth, np.float32)
        h, w = gray.shape
        return self._lib.ovo_tracker_process_image_rgbd(
            self._h, gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            w, h, fx, fy, cx, cy, timestamp)

    def get_last_trajectory_point(self) -> np.ndarray:
        out = (ctypes.c_double * 16)()
        self._lib.ovo_tracker_get_last_trajectory_point(self._h, out)
        return np.asarray(out, dtype=np.float64).reshape(4, 4)

    def get_tracking_state(self) -> int:
        return self._lib.ovo_tracker_get_tracking_state(self._h)

    def is_last_frame_kf(self) -> bool:
        return bool(self._lib.ovo_tracker_is_last_frame_kf(self._h))

    def get_last_big_change_idx(self) -> int:
        return self._lib.ovo_tracker_get_last_big_change_idx(self._h)

    def last_inlier_ratio(self) -> float:
        return self._lib.ovo_tracker_last_inlier_ratio(self._h)

    def num_keyframes(self) -> int:
        return self._lib.ovo_tracker_num_keyframes(self._h)

    def get_keyframes(self):
        """Every stored keyframe as (frame_id, c2w, culled), the poses
        loop-corrected."""
        out = []
        buf = (ctypes.c_double * 16)()
        for i in range(self.num_keyframes()):
            fid = self._lib.ovo_tracker_get_keyframe_pose(self._h, i, buf)
            pose = np.array(buf, dtype=np.float64).reshape(4, 4)
            culled = bool(self._lib.ovo_tracker_keyframe_culled(self._h, i))
            out.append((fid, pose, culled))
        return out

    def get_keyframe_points(self) -> np.ndarray:
        """(n_live_kf, 13) rows [frame_id, c2w[:3, :4].flatten()], culled
        keyframes left out (the orbslam3 binding's ``updated_kfs``)."""
        rows = [np.concatenate([[float(fid)], pose[:3, :4].reshape(-1)])
                for fid, pose, culled in self.get_keyframes() if not culled]
        return (np.stack(rows).astype(np.float64) if rows
                else np.zeros((0, 13)))

    def set_loop_params(self, min_kf_gap: int = 0, radius: float = 0.0,
                        rot_limit: float = 0.0, inlier_th: float = 0.0):
        """Loop-closure gates; a non-positive value keeps the default."""
        self._lib.ovo_tracker_set_loop_params(self._h, min_kf_gap, radius,
                                              rot_limit, inlier_th)

    def shutdown(self) -> None:
        if self._h:
            self._lib.ovo_tracker_destroy(self._h)
            self._h = None


def map_count(state: MapState) -> int:
    """The map's point count on the host: the ORB tier's one read of the
    device per tracker keyframe."""
    return int(state.count)


class WrapperORBSLAM(VanillaMapper):
    """The vanilla mapper's geometry with the native tracker's poses."""

    def __init__(self, config: Dict[str, Any], cam_intrinsics,
                 world_ref: np.ndarray | None = None, device="cuda"):
        super().__init__(config, cam_intrinsics, resolve_device(device))
        # keyframe-gated inserts and rebuilds never take the fused
        # associate + insert
        self.supports_fused_insert = False
        self._K = np.asarray(cam_intrinsics, np.float32)
        slam_cfg = config.get("slam", {})
        self.tracker = NativeTracker(
            kf_trans_th=slam_cfg.get("kf_trans_th", 0.15),
            kf_rot_th=slam_cfg.get("kf_rot_th", 0.15),
            kf_inlier_th=slam_cfg.get("kf_inlier_th", 0.6))
        # loop gates from the config (non-positive keeps the tracker's);
        # close_loops: false makes the candidate gap unreachable
        if slam_cfg.get("close_loops", True):
            self.tracker.set_loop_params(
                min_kf_gap=int(slam_cfg.get("loop_min_kf_gap", 0)),
                radius=float(slam_cfg.get("loop_radius", 0.0)),
                rot_limit=float(slam_cfg.get("loop_rot_limit", 0.0)),
                inlier_th=float(slam_cfg.get("loop_inlier_th", 0.0)))
        else:
            self.tracker.set_loop_params(min_kf_gap=1 << 30)
        # tracker poses are relative to the first frame: anchor them at the
        # dataset's first pose
        self.world_ref = (np.asarray(world_ref, np.float32)
                          if world_ref is not None
                          else np.eye(4, dtype=np.float32))
        self.kf_blocks: Dict[int, Dict[str, Any]] = {}
        self._blocks_end = 0
        self.last_big_change = 0
        self._last_was_kf = False

    def track_camera(self, frame_data: List[Any]) -> None:
        frame_id, image, depth = frame_data[0], frame_data[1], frame_data[2]
        gray = np.asarray(image, np.float32).mean(axis=-1) / 255.0
        K = self._K
        state = self.tracker.process_image_rgbd(
            gray, depth, float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
            float(K[1, 2]), float(frame_id))
        if state != STATE_OK:
            print(f"Tracking state {state} at frame {frame_id}")
            return
        rel = self.tracker.get_last_trajectory_point().astype(np.float32)
        self.estimated_c2ws[frame_id] = self.world_ref @ rel
        self._last_was_kf = self.tracker.is_last_frame_kf()

    def map(self, frame_data: List[Any], c2w) -> None:
        """Insert on tracker keyframes only, recording the keyframe's block
        of point rows for later rebuilds."""
        if not self._last_was_kf:
            self._poll_big_change()
            return
        start = self._blocks_end
        super().map(frame_data, c2w)
        end = map_count(self.state)
        self._blocks_end = end
        frame_id = frame_data[0]
        self.kf_blocks[frame_id] = {"range": (start, end),
                                    "c2w": np.asarray(c2w, np.float32)}
        self.kfs[frame_id] = True
        self._poll_big_change()

    def _poll_big_change(self) -> None:
        idx = self.tracker.get_last_big_change_idx()
        if idx == self.last_big_change:
            return
        self.last_big_change = idx
        # keyframe poses from the tracker's loop-corrected store; the
        # culled ones are dropped
        culled_ids = set()
        for fid, pose, culled in self.tracker.get_keyframes():
            frame_id = int(round(fid))
            if culled:
                culled_ids.add(frame_id)
            else:
                self.estimated_c2ws[frame_id] = (
                    self.world_ref @ pose.astype(np.float32))
        self._rebuild_map(culled_ids)
        for fid in culled_ids:
            self.kfs.pop(fid, None)
        self.map_updated = True

    def _rebuild_map(self, culled_ids=frozenset()) -> None:
        """Move each keyframe's block rigidly to its corrected pose and drop
        the blocks of culled keyframes, in one pass over the map on the
        device. The block axis is padded to a power of 2 (+1 identity
        row), as the reference pads it."""
        blocks = list(self.kf_blocks.items())
        if not blocks:
            return
        n_b = len(blocks)
        bp = 1
        while bp < n_b + 1:
            bp *= 2
        starts = np.empty((bp,), np.int32)
        deltas = np.tile(np.eye(3, 4, dtype=np.float32), (bp, 1, 1))
        keep = np.ones((bp,), np.float32)
        for b, (frame_id, blk) in enumerate(blocks):
            starts[b] = blk["range"][0]
            if frame_id in culled_ids:
                keep[b] = 0.0
                continue
            new_c2w = self.estimated_c2ws.get(frame_id)
            if new_c2w is None:
                continue
            delta = new_c2w @ np.linalg.inv(blk["c2w"])
            deltas[b] = delta[:3, :4]
            blk["c2w"] = np.asarray(new_c2w, np.float32)
        starts[n_b:] = blocks[-1][1]["range"][1]
        compact = bool(culled_ids)
        dev = self.device
        self.state = _apply_block_deltas(
            self.state, to_device(starts, dev), to_device(deltas, dev),
            to_device(keep, dev), compact=compact)
        if compact:
            # whole blocks went: the surviving ranges shift down
            dropped = 0
            new_blocks: Dict[int, Dict[str, Any]] = {}
            for frame_id, blk in blocks:
                s, e = blk["range"]
                if frame_id in culled_ids:
                    dropped += e - s
                    continue
                blk["range"] = (s - dropped, e - dropped)
                new_blocks[frame_id] = blk
            self.kf_blocks = new_blocks
            # the new count is the last surviving block's end; the host's
            # count bounds (_count_ub, _count_known) only shrink, so they
            # stay upper bounds
            self._blocks_end = (next(reversed(new_blocks.values()))[
                "range"][1] if new_blocks else 0)


@torch.no_grad()
def _apply_block_deltas(state: MapState, starts: torch.Tensor,
                        deltas: torch.Tensor, keep: torch.Tensor, *,
                        compact: bool) -> MapState:
    """Per-keyframe-block rigid corrections of the point map.

    starts: (Bp,) i32, block b covers rows [starts[b], starts[b+1]); the
            tail is padded with the last block's end, so rows past it take
            the identity row Bp-1.
    deltas: (Bp, 3, 4) f32 rigid transforms (row Bp-1 and padding identity).
    keep:   (Bp,) f32 0/1; 0 drops the whole block (a culled keyframe),
            compacting the survivors in order (only with ``compact``).
    """
    n = state.capacity
    bp = deltas.shape[0]
    dev = state.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    blk = torch.searchsorted(starts.to(torch.int32), idx, right=True).to(
        torch.int32) - 1
    blk = torch.where((blk < 0) | (blk >= bp), torch.full_like(blk, bp - 1),
                      blk)
    m = segment_mxu.table_lookup(blk, deltas.reshape(bp, 12)).reshape(n, 3, 4)
    p = state.points
    pts = (m[:, :, 0] * p[:, 0:1] + m[:, :, 1] * p[:, 1:2]
           + m[:, :, 2] * p[:, 2:3]) + m[:, :, 3]
    if not compact:
        return state._replace(points=pts)
    keep_pt = (segment_mxu.table_lookup(blk, keep) > 0.5) & (idx < state.count)
    perm = torch.argsort((~keep_pt).to(torch.uint8), stable=True)
    return MapState(
        points=pts[perm],
        point_ids=state.point_ids[perm],
        obj_ids=state.obj_ids[perm],
        colors=state.colors[perm],
        count=keep_pt.sum().to(torch.int32),
        next_point_id=state.next_point_id,
    )
