"""Application facade (counterpart of `ra_slam_tpu/pipeline/system.py`).

`RaSlamSystem` owns the sparse SLAM system, the segmentation engine, the
TSDF voxel map and the pose buffer on one device and exposes the
robot-facing API:

    feed_tracking_frame()  — tracking camera (RGB-D) -> SLAM -> pose buffer
    feed_stereo_frame()    — the same from a rectified stereo pair
    feed_rgbd_frame()      — depth camera -> segment -> TSDF integrate, at
                             a given pose or, with `pose=None`, at the
                             tracked pose of its timestamp
    query_tsdf()           — AABB voxel query for the planner
    query_camera_pose()    — tracked pose at a timestamp
    render()               — raycast virtual view (`map/raycast.py`)
    download_all()         — reference-format (x, y, z, tsdf, prob) dump
    download_all_mesh()    — reference-format mesh dump (`map/meshing.py`)
    semantic_voxels()      — the same rows as an array
    last_pose              — the cam_T_world the last depth frame was
                             fused at (None before the first)

Depth frames are fused with the depth camera's intrinsics:
`cfg.depth_camera` where it is set (a depth camera beside the tracking
camera, as the robot's L515 beside its ZED), else `cfg.camera`. Where
`cfg.dense_stereo` is set the depth frames are the stereo tracking
camera's own (the rectified left view and its dense depth, as
`io/cameras.py:ZedDepthCamera` gives them): they are fused with
`cfg.camera`, and a depth camera or extrinsics is refused. A stereo
tracking camera's keypoint depths count out to `STEREO_DEPTH_THRESHOLD`
baselines, and are searched from `MIN_KEYPOINT_DEPTH`
(`keypoint_search_range`).

`feed_rgbd_frame` takes numpy arrays, or tensors on any device: a tensor
is moved and cast on the device, never copied to the host.

A frame of another size than the map's feed size is resized on the
device as the JAX facade does with cv2: colour INTER_LINEAR, depth
INTER_NEAREST (`ops/resize.py`); caller-given ht/lt maps are not
resized. Frames without maps are segmented on the device by the
engine (`models/segmentation.py`).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import SystemConfig, TrackingConfig
from ra_slam_tpu_torch.core.device import resolve_device
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.map.meshing import extract_mesh, save_mesh
from ra_slam_tpu_torch.map.raycast import raycast
from ra_slam_tpu_torch.map.voxel_map import (
    create_map,
    dump_semantic_tsdf,
    gather_valid_semantic,
    integrate_frame,
    query_tsdf,
)
from ra_slam_tpu_torch.models.segmentation import InferenceEngine
from ra_slam_tpu_torch.ops.resize import resize_linear, resize_nearest
from ra_slam_tpu_torch.slam.system import SlamSystem
from ra_slam_tpu_torch.utils.profiling import TRACE


# A stereo tracking camera's keypoint depths are trusted out to this many
# baselines (OpenVSLAM's Camera.depth_threshold, ORB-SLAM2's ThDepth: 40 in
# their stereo example configurations). A farther keypoint tracks the
# landmarks it matches but makes none. At the ZED's 0.12 m baseline that is
# 4.8 m, a disparity of ~8 px; the landmarks of farther, noisier depths
# drifted a ZED walk to 7-9 cm ATE in 420 pairs, 2-3 cm without them.
STEREO_DEPTH_THRESHOLD = 40.0
# The nearest keypoint depth the stereo tracker searches for (m), and its
# least search range (px), the JAX package's fixed one.
MIN_KEYPOINT_DEPTH = 0.7
MIN_KEYPOINT_DISPARITY = 64


def keypoint_search_range(focal_x_baseline: float) -> int:
    """The stereo tracker's keypoint disparity range: out to
    `MIN_KEYPOINT_DEPTH`, rounded up to a multiple of 32, and at least
    `MIN_KEYPOINT_DISPARITY`. 64 for the ZED at 672x376 (fx b ~ 40 px m),
    128 at 1280x720 (~81 px m): keypoint depths from ~0.63 m on both."""
    return max(MIN_KEYPOINT_DISPARITY, 32 * math.ceil(focal_x_baseline / MIN_KEYPOINT_DEPTH / 32))


class RaSlamSystem:
    """Semantic reconstruction system on one device."""

    def __init__(
        self,
        cfg: SystemConfig,
        device,
        segmentation_model: Optional[str] = None,
        enable_tracking: bool = True,
        alloc_stride: int = 2,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.alloc_stride = alloc_stride
        tsdf = cfg.tsdf
        if cfg.dense_stereo is not None and (cfg.depth_camera is not None or cfg.extrinsics is not None):
            raise ValueError("dense_stereo fuses the tracking camera's own depth: a depth camera or extrinsics "
                             "does not apply")
        dcam = cfg.depth_camera or cfg.camera
        self.tsdf_cam = PinholeCamera.create(
            dcam.fx, dcam.fy, dcam.cx, dcam.cy, dcam.width, dcam.height,
        ).resized(tsdf.width, tsdf.height)
        # depth-camera -> tracking-camera extrinsics, applied to queried poses
        self.extrinsics: Optional[SE3] = None
        if cfg.extrinsics is not None:
            m = torch.as_tensor(np.array(cfg.extrinsics, np.float32).reshape(4, 4))
            self.extrinsics = SE3.from_matrix(m.to(self.device))
        self.seg = InferenceEngine(segmentation_model, width=tsdf.width, height=tsdf.height,
                                   device=self.device)
        self.map = create_map(tsdf, self.device)

        self.slam: Optional[SlamSystem] = None
        if enable_tracking:
            cam = cfg.camera
            track_cam = PinholeCamera.create(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
            # untouched default gates are calibrated at 320-wide images:
            # scale them (and the loop/reloc rmse gates) to this camera as
            # angular windows; an explicit tracking config passes unscaled
            tcfg, scale = cfg.tracking, 1.0
            if tcfg == TrackingConfig():
                scale = cam.width / 320.0
                tcfg = tcfg.scaled(scale)
            if cam.focal_x_baseline > 0:
                # tcfg.max_depth gates the keypoint depths a frame makes
                tcfg = dataclasses.replace(tcfg, max_depth=min(
                    tcfg.max_depth, STEREO_DEPTH_THRESHOLD * cam.focal_x_baseline / cam.fx))
            self.slam = SlamSystem(
                track_cam, fcfg=cfg.feature, tcfg=tcfg,
                loop_max_rmse=3.0 * scale, reloc_max_rmse=3.0 * scale,
                focal_x_baseline=cam.focal_x_baseline,
                max_disparity=keypoint_search_range(cam.focal_x_baseline), device=self.device,
            )
        self.last_stats: dict = {}
        self.last_pose: Optional[SE3] = None
        self.num_integrated = 0
        # serializes map access between camera threads; the map is
        # updated in place
        self._lock = threading.RLock()

    def _tensor(self, a) -> torch.Tensor:
        """float32 on the device; a tensor is cast there, with no host copy."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def feed_tracking_frame(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float,
                            pose_hint: Optional[SE3] = None):
        """Feed the tracking camera: track, and register the pose in the
        buffer only when tracking succeeded."""
        if self.slam is None:
            raise RuntimeError("tracking disabled")
        with TRACE.span("facade.feed_tracking"), self._lock:
            return self.slam.feed_rgbd_frame(rgb, depth, timestamp, pose_hint=pose_hint)

    def feed_stereo_frame(self, left: np.ndarray, right: np.ndarray, timestamp: float,
                          pose_hint: Optional[SE3] = None):
        """The rectified stereo tracking-camera path."""
        if self.slam is None:
            raise RuntimeError("tracking disabled")
        with TRACE.span("facade.feed_stereo"), self._lock:
            return self.slam.feed_stereo_frame(left, right, timestamp, pose_hint=pose_hint)

    def feed_rgbd_frame(
        self,
        rgb,
        depth,
        timestamp: float,
        pose: Optional[SE3] = None,
        ht: Optional[np.ndarray] = None,
        lt: Optional[np.ndarray] = None,
    ) -> dict:
        """Segment + integrate one depth-camera frame. `pose`
        (cam_T_world) overrides the pose-buffer query; without it the
        frame is fused at the tracked pose of its timestamp, and skipped
        while tracking is lost or before any pose. Returns the integrate
        stats as ints (or {"skipped": why})."""
        with TRACE.span("facade.feed_rgbd"):
            return self._feed_rgbd(rgb, depth, timestamp, pose, ht, lt)

    def _feed_rgbd(self, rgb, depth, timestamp: float, pose: Optional[SE3], ht, lt) -> dict:
        tsdf = self.cfg.tsdf
        if pose is None:
            if self.slam is None:
                raise ValueError("no pose source: tracking is disabled, pass cam_T_world")
            if self.slam.lost:
                # fusing with a stale pose corrupts the map
                return {"skipped": "tracking lost"}
            with TRACE.span("facade.pose_query"):
                pose = self.slam.query_pose(timestamp)
                if pose is None:
                    return {"skipped": "no pose"}
                pose = SE3(pose.R.to(self.device, torch.float32), pose.t.to(self.device, torch.float32))
                if self.extrinsics is not None:
                    pose = self.extrinsics @ pose
        with TRACE.span("facade.upload"):
            if isinstance(rgb, torch.Tensor):
                rgb_t = rgb.to(self.device) if rgb.dtype == torch.uint8 else self._tensor(rgb)
            else:
                rgb = np.asarray(rgb)
                rgb_t = torch.as_tensor(rgb if rgb.dtype == np.uint8 else rgb.astype(np.float32)).to(self.device)
            depth_t = self._tensor(depth)
            if rgb_t.shape[:2] != (tsdf.height, tsdf.width):
                rgb_t = resize_linear(rgb_t, tsdf.width, tsdf.height)
            if depth_t.shape != (tsdf.height, tsdf.width):
                depth_t = resize_nearest(depth_t, tsdf.width, tsdf.height)
        if ht is None or lt is None:
            ht_t, lt_t = self.seg.segment(rgb_t)
        else:
            ht_t, lt_t = self._tensor(ht), self._tensor(lt)
        pose = SE3(pose.R.to(self.device, torch.float32), pose.t.to(self.device, torch.float32))
        with self._lock:
            self.map, stats = integrate_frame(
                self.map, rgb_t.to(torch.float32), depth_t, ht_t, lt_t,
                self.tsdf_cam, pose, tsdf, alloc_stride=self.alloc_stride,
            )
            self.num_integrated += 1
            self.last_pose = pose
            with TRACE.wait("facade.stats"):
                self.last_stats = {k: int(v) for k, v in stats.items()}
            return self.last_stats

    def query_camera_pose(self, timestamp: float) -> Optional[SE3]:
        if self.slam is None:
            raise RuntimeError("tracking disabled")
        return self.slam.query_pose(timestamp)

    def query_tsdf(self, lo, hi) -> np.ndarray:
        """(x, y, z, tsdf) rows inside the AABB (planner API)."""
        with self._lock:
            return query_tsdf(self.map, self.cfg.tsdf, lo, hi)

    def render(self, cam_T_world: SE3, cam: Optional[PinholeCamera] = None) -> dict:
        """Raycast a virtual view (default: the map's feed camera); the
        `raycast` dict of device tensors (depth, rgba, normal, hit,
        dropped_splats)."""
        pose = SE3(cam_T_world.R.to(self.device, torch.float32), cam_T_world.t.to(self.device, torch.float32))
        with self._lock:
            return raycast(self.map, cam or self.tsdf_cam, pose, self.cfg.tsdf)

    def download_all(self, path: str) -> int:
        with self._lock:
            return dump_semantic_tsdf(self.map, self.cfg.tsdf, path)

    def download_all_mesh(self, vertices_path: str, indices_path: str, prob_path: str) -> Tuple[int, int]:
        """Extract the mesh and write the three `.bin` dumps; returns
        (vertices, triangles)."""
        with self._lock:
            verts, idx, probs = extract_mesh(self.map, self.cfg.tsdf)
        save_mesh(verts, idx, probs, vertices_path, indices_path, prob_path)
        return len(verts), len(idx)

    def semantic_voxels(self) -> np.ndarray:
        with self._lock:
            return gather_valid_semantic(self.map, self.cfg.tsdf)

    def synchronize(self) -> None:
        """Wait for the device work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
