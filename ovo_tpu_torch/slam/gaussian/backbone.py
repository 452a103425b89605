"""Gaussian-SLAM backbone tier behind the common backbone interface (port
of ``ovo_tpu/slam/gaussian/backbone.py``).

Tracking renders the gaussian map and optimizes each frame's pose
(``tracker.track_pose``) from the native odometry's relative pose or a
const-speed guess; mapping seeds, grows and optimizes the map on the
mapping cadence (``mapper.map_keyframe``) over a window of keyframes. The
semantic side sees the live gaussians as a ``MapState`` (live slots first,
in slot order); instance ids written back scatter through the same
permutation.

Poses stay on the host (numpy f32), as the pipeline reads them; the map
and the keyframe window stay on the device. The host reads of a frame go
through ``ops/splat.read_host``: two per tracked frame; per mapped
keyframe two (one for a new submap), one per ``mapper.PAIR_CHECK_EVERY``
mapping iterations and one per K-escalation attempt.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ... import resolve_device, to_device
from ...mapping.map_state import MapState
from ...ops.splat import render_gaussians, render_gaussians_adaptive
from .mapper import MapperConfig, map_keyframe
from .model import (GaussianState, from_gaussian_map_dict, gaussian_map_dict,
                    init_gaussian_state)
from .tracker import const_speed_extrapolate, track_pose


class WrapperGaussianSLAM:
    def __init__(self, config: Dict[str, Any], cam_intrinsics,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self.config = config
        self.K = to_device(np.asarray(cam_intrinsics, np.float32),
                           self.device)
        mapping = config.get("mapping", {})
        tracking = config.get("tracking", {}) or {}
        capacity = int(mapping.get("n_gaussians_capacity", 2 ** 20))
        self.state: GaussianState = init_gaussian_state(capacity,
                                                        self.device)
        # the reference's key names (slam/gaussian_slam/*.yaml) first, this
        # package's as fallbacks
        dataset_name = str(config.get("dataset_name", "")).lower()
        self.cfg = MapperConfig(
            iters=int(mapping.get("iterations", 60)),
            prune_opacity_th=float(
                mapping.get("pruning_thre",
                            mapping.get("prune_opacity_th", 0.1))),
            max_seeds=int(mapping.get("max_seeds", 16384)),
            dedup_radius=float(
                mapping.get("new_points_radius",
                            mapping.get("dedup_radius", 0.02))),
            k_per_tile=int(mapping.get("k_per_tile", 128)),
            densify_grad_th=float(mapping.get("densify_grad_th", 0.0)),
            densify_percent_dense=float(
                mapping.get("densify_percent_dense", 0.01)),
            new_submap_iters=int(mapping.get("new_submap_iterations", 0)),
            new_submap_max_seeds=int(
                mapping.get("new_submap_points_num",
                            mapping.get("new_submap_max_seeds", 0))),
            current_frame_frac=float(
                mapping.get("current_view_opt_iterations", 0.4)),
            alpha_th=float(mapping.get("alpha_thre", 0.6)),
            # seeds at 1.005 * depth put every seed of a constant-depth
            # wall behind the association frustum's far plane: such scenes
            # pin 1.0
            seed_depth_mult=float(mapping.get("seed_depth_mult", 1.005)),
            filter_seed_outliers=bool(mapping.get(
                "filter_seed_outliers",
                dataset_name in ("scannet", "tum_rgbd", "tum"))),
        )
        # K-truncation escalation: checked once per mapped keyframe; an
        # escalated k_per_tile is kept for every later render
        self.adaptive_k = bool(mapping.get("adaptive_k_per_tile", True))
        self.k_residual_th = float(mapping.get("k_residual_th", 0.05))
        self.max_k_per_tile = int(mapping.get(
            "max_k_per_tile", min(8 * self.cfg.k_per_tile, 1024)))
        self.track_iters = int(tracking.get("iterations", 60))
        self.gt_camera = bool(tracking.get("gt_camera", False))
        self.adaptive_loss_th = float(tracking.get("adaptive_loss_th", 0.0))
        # total = w_color_loss * color + (1 - w_color_loss) * depth;
        # init_err_ratio doubles the iterations when the initial loss
        # exceeds ratio x the median of the recorded final losses
        w_color = tracking.get("w_color_loss")
        self.track_color_w = float(w_color) if w_color is not None else 0.5
        self.track_depth_w = (1.0 - float(w_color)
                              if w_color is not None else 1.0)
        self.track_lr_q = float(tracking.get("cam_rot_lr", 2e-4))
        self.track_lr_t = float(tracking.get("cam_trans_lr", 2e-3))
        self.track_alpha_th = float(tracking.get("alpha_thre", 0.98))
        self.track_soft_alpha = bool(tracking.get("soft_alpha", True))
        self.track_filter_alpha = bool(tracking.get("filter_alpha", False))
        self.track_filter_outlier = bool(
            tracking.get("filter_outlier_depth", True))
        self.track_mask_invalid = bool(
            tracking.get("mask_invalid_depth", False))
        self.init_err_ratio = float(tracking.get("init_err_ratio", 0.0))
        self._track_loss_hist: List[float] = []
        self.odometer = None
        # tracking.odometry_type in {gt, const_speed, odometer}
        odo_type = tracking.get("odometry_type")
        if odo_type == "gt":
            self.gt_camera = True
        init = tracking.get("init",
                            "odometry" if odo_type == "odometer"
                            else "const_speed")
        if init == "odometry":
            try:
                from .odometer import VisualOdometer

                K = np.asarray(cam_intrinsics)
                self.odometer = VisualOdometer(float(K[0, 0]),
                                               float(K[1, 1]),
                                               float(K[0, 2]),
                                               float(K[1, 2]))
            except OSError as e:  # the native library did not load
                print(f"[ovo_tpu_torch] odometry init unavailable ({e}); "
                      "falling back to const-speed")
        self.kf_window = int(mapping.get("keyframe_window", 6))
        self.new_submap_every = int(mapping.get("new_submap_every", 50))
        self.log_psnr = bool(mapping.get("log_psnr", False))
        # render-vs-gt panels under <output>/mapping_vis/ (0 = off)
        self.vis_every = int(mapping.get("vis_every", 0))
        self.output_path = config.get("output_path")
        self.psnr_log: Dict[int, float] = {}
        self.estimated_c2ws: Dict[int, np.ndarray] = {}
        self.kfs: Dict[int, Any] = {}
        self._kf_images: List[torch.Tensor] = []
        self._kf_depths: List[torch.Tensor] = []
        self._kf_w2cs: List[torch.Tensor] = []
        self._n_mapped = 0
        self._view_perm: Optional[torch.Tensor] = None
        # the pair buffer of the last renders (ops/splat.py), a hint for
        # the next tracked frame's first render
        self._pair_cap: Optional[int] = None
        self.map_updated = False
        self.supports_fused_insert = False

    def _image(self, image) -> torch.Tensor:
        img = np.asarray(image)
        t = to_device(img, self.device)
        return (t.to(torch.float32) / 255.0 if img.dtype == np.uint8
                else t.to(torch.float32))

    # -- tracking --------------------------------------------------------
    def track_camera(self, frame_data: List[Any]) -> None:
        frame_id, image, depth, gt_c2w = frame_data[:4]
        gt_ok = not (np.isinf(gt_c2w).any() or np.isnan(gt_c2w).any())
        prev = sorted(self.estimated_c2ws)
        odo_rel = (self.odometer.estimate_rel_pose(image, depth)
                   if self.odometer is not None else None)
        if self.gt_camera or len(prev) < 2 or self._n_mapped == 0:
            if gt_ok:
                self.estimated_c2ws[frame_id] = np.asarray(gt_c2w, np.float32)
            return
        # pose init: the odometry's relative pose when it has one, else
        # const speed
        c2w1 = self.estimated_c2ws[prev[-1]]
        if odo_rel is not None:
            c2w_init = c2w1 @ np.asarray(odo_rel, np.float32)
        else:
            c2w_init = const_speed_extrapolate(
                self.estimated_c2ws[prev[-2]], c2w1)
        adaptive_th = self.adaptive_loss_th
        if self.init_err_ratio > 0 and self._track_loss_hist:
            adaptive_th = (self.init_err_ratio
                           * float(np.median(self._track_loss_hist)))
        dep = to_device(np.asarray(depth, np.float32), self.device)
        w2c_init = to_device(np.linalg.inv(c2w_init).astype(np.float32),
                             self.device)
        res = track_pose(self.state, self._image(image), dep, w2c_init,
                         self.K, img_hw=tuple(dep.shape),
                         iters=self.track_iters,
                         color_w=self.track_color_w,
                         depth_w=self.track_depth_w,
                         lr_q=self.track_lr_q, lr_t=self.track_lr_t,
                         alpha_th=self.track_alpha_th,
                         soft_alpha=self.track_soft_alpha,
                         filter_alpha=self.track_filter_alpha,
                         filter_outlier_depth=self.track_filter_outlier,
                         mask_invalid_depth=self.track_mask_invalid,
                         adaptive_loss_th=adaptive_th,
                         k_per_tile=self.cfg.k_per_tile,
                         pair_cap=self._pair_cap)
        self._pair_cap = res.pair_cap
        if self.init_err_ratio > 0:
            self._track_loss_hist.append(res.loss)
        self.estimated_c2ws[frame_id] = np.linalg.inv(res.w2c).astype(
            np.float32)

    def get_c2w(self, frame_id: int):
        return self.estimated_c2ws.get(frame_id)

    # -- mapping ---------------------------------------------------------
    def map(self, frame_data: List[Any], c2w) -> None:
        frame_id, image, depth = frame_data[0], frame_data[1], frame_data[2]
        img = self._image(image)
        dep = to_device(np.asarray(depth, np.float32), self.device)
        c2w = np.asarray(c2w, np.float32)
        w2c = to_device(np.linalg.inv(c2w).astype(np.float32), self.device)
        self._kf_images.append(img)
        self._kf_depths.append(dep)
        self._kf_w2cs.append(w2c)
        if len(self._kf_images) > self.kf_window:
            self._kf_images.pop(0)
            self._kf_depths.pop(0)
            self._kf_w2cs.pop(0)

        is_new_submap = (self._n_mapped % self.new_submap_every) == 0
        # the window padded to kf_window with the newest keyframe
        n_live = len(self._kf_images)
        pad = self.kf_window - n_live

        def stack_pad(lst):
            return torch.stack(lst + [lst[-1]] * pad)

        hw = tuple(dep.shape)
        self.state = map_keyframe(
            self.state, img, dep, w2c, self.K,
            stack_pad(self._kf_images), stack_pad(self._kf_depths),
            stack_pad(self._kf_w2cs), is_new_submap=is_new_submap,
            seed=frame_id, n_live_kfs=n_live, img_hw=hw, cfg=self.cfg,
            c2w=to_device(c2w, self.device))
        self.kfs[frame_id] = None
        self._n_mapped += 1
        self._view_perm = None  # the map changed: a new semantic view
        st = self.state
        if self.adaptive_k:
            # a truncated tile keeping > k_residual_th of its weight past
            # K escalates k_per_tile (power-of-2 steps, kept)
            with torch.no_grad():
                _, k_used, self._pair_cap = render_gaussians_adaptive(
                    st.xyz, st.scales(), st.quats, st.opacity(),
                    st.colors(), st.valid, w2c, self.K, img_hw=hw,
                    k_per_tile=self.cfg.k_per_tile,
                    residual_th=self.k_residual_th,
                    max_k=self.max_k_per_tile, pair_cap=self._pair_cap)
            if k_used > self.cfg.k_per_tile:
                print(f"[gaussian] K-truncation residual > "
                      f"{self.k_residual_th}: k_per_tile "
                      f"{self.cfg.k_per_tile} -> {k_used}")
                self.cfg = self.cfg._replace(k_per_tile=k_used)
        dump_vis = (self.vis_every > 0 and self.output_path
                    and (self._n_mapped - 1) % self.vis_every == 0)
        if self.log_psnr or dump_vis:
            self._log_render(frame_id, img, dep, w2c, hw, dump_vis)

    def _log_render(self, frame_id, img, dep, w2c, hw, dump_vis) -> None:
        """PSNR of the mapped view and / or its render-vs-input panels
        under mapping_vis/ (host reads)."""
        from .losses import psnr

        st = self.state
        with torch.no_grad():
            out = render_gaussians(st.xyz, st.scales(), st.quats,
                                   st.opacity(), st.colors(), st.valid, w2c,
                                   self.K, img_hw=hw,
                                   k_per_tile=self.cfg.k_per_tile)
        if self.log_psnr:
            self.psnr_log[frame_id] = float(psnr(out.color, img,
                                                 mask=out.alpha > 0.5))
        if dump_vis:
            import imageio.v2 as imageio
            from pathlib import Path

            vis_dir = Path(self.output_path) / "mapping_vis"
            vis_dir.mkdir(parents=True, exist_ok=True)
            rgb = torch.cat([out.color, img], 1).cpu().numpy()
            imageio.imwrite(vis_dir / f"{frame_id:04d}_color.png",
                            (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            dmax = max(float(dep.max()), 1e-6)
            dpair = torch.cat([out.depth, dep], 1).cpu().numpy() / dmax
            imageio.imwrite(vis_dir / f"{frame_id:04d}_depth.png",
                            (np.clip(dpair, 0, 1) * 255).astype(np.uint8))

    # -- the semantic side's view (MapState compaction) ------------------
    def _perm(self) -> torch.Tensor:
        if self._view_perm is None:
            self._view_perm = torch.argsort(~self.state.valid, stable=True)
        return self._view_perm

    def get_map(self) -> MapState:
        perm = self._perm()
        st = self.state
        live = st.valid[perm]
        colors_u8 = (st.colors() * 255.0).to(torch.uint8)
        return MapState(
            points=st.xyz[perm],
            point_ids=torch.where(live, st.ids[perm], -1),
            obj_ids=torch.where(live, st.obj_ids[perm], -1),
            colors=colors_u8[perm],
            count=st.valid.sum().to(torch.int32),
            # a copy: the semantic side may update its view in place
            next_point_id=st.next_id.clone(),
        )

    def update_pcd_obj_ids(self, state_or_ids) -> None:
        perm = self._perm()
        obj = (state_or_ids.obj_ids if isinstance(state_or_ids, MapState)
               else to_device(np.asarray(state_or_ids, np.int32),
                              self.device))
        new_obj = torch.empty_like(self.state.obj_ids).scatter_(
            0, perm, obj.to(torch.int32))
        self.state = self.state._replace(
            obj_ids=torch.where(self.state.valid, new_obj,
                                self.state.obj_ids))

    def get_pcd_colors(self) -> np.ndarray:
        m = self.get_map()
        return m.colors[: int(m.count)].cpu().numpy()

    def get_kfs(self):
        return self.kfs

    # -- gaussian ply IO ---------------------------------------------------
    def save_ply(self, path) -> None:
        from .model import save_gaussian_ply

        save_gaussian_ply(self.state, path)

    def load_ply(self, path) -> None:
        from .model import load_gaussian_ply

        self.state = load_gaussian_ply(path, self.state.capacity,
                                       self.device)
        self._view_perm = None

    # -- checkpointing (the reference's capture layout) -------------------
    def get_map_dict(self) -> Dict[str, Any]:
        return gaussian_map_dict(self.state)

    def set_map_dict(self, d: Dict[str, Any]) -> None:
        self.state = from_gaussian_map_dict(d, self.state.capacity,
                                            self.device)
        self._view_perm = None

    def get_cam_dict(self) -> Dict[int, np.ndarray]:
        return {k: np.asarray(v) for k, v in self.estimated_c2ws.items()}

    def set_cam_dict(self, cam_dict: Dict[Any, Any]) -> None:
        self.estimated_c2ws = {int(k): np.asarray(v, np.float32)
                               for k, v in cam_dict.items()}
