"""Application facade (counterpart of `ra_slam_tpu/pipeline/system.py`).

`RaSlamSystem` owns the segmentation engine and the TSDF voxel map on
one device and exposes the depth-camera half of the robot-facing API:

    feed_rgbd_frame()  — depth camera -> segment -> TSDF integrate, with
                         a known pose (GT replay)
    query_tsdf()       — AABB voxel query for the planner
    download_all()     — reference-format (x, y, z, tsdf, prob) dump
    semantic_voxels()  — the same rows as an array

Tracking, raycast rendering and the mesh dump are not ported yet
(ROADMAP); `enable_tracking=True` raises.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import SystemConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.map.voxel_map import (
    create_map,
    dump_semantic_tsdf,
    gather_valid_semantic,
    integrate_frame,
    query_tsdf,
)
from ra_slam_tpu_torch.models.segmentation import InferenceEngine


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device when torch
    sees none (there is no silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False"
        )
    return device


class RaSlamSystem:
    """Semantic reconstruction system on one device."""

    def __init__(
        self,
        cfg: SystemConfig,
        device,
        segmentation_model: Optional[str] = None,
        enable_tracking: bool = False,
        alloc_stride: int = 2,
    ):
        if enable_tracking:
            raise NotImplementedError("tracking is not ported yet; feed known poses")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.alloc_stride = alloc_stride
        tsdf = cfg.tsdf
        self.tsdf_cam = PinholeCamera.create(
            cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
            cfg.camera.width, cfg.camera.height,
        ).resized(tsdf.width, tsdf.height)
        self.seg = InferenceEngine(segmentation_model, width=tsdf.width, height=tsdf.height)
        self.map = create_map(tsdf, self.device)
        self.last_stats: dict = {}
        self.num_integrated = 0
        # serializes map access between camera threads; the map is
        # updated in place
        self._lock = threading.RLock()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def feed_rgbd_frame(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        timestamp: float,
        pose: SE3,
        ht: Optional[np.ndarray] = None,
        lt: Optional[np.ndarray] = None,
    ) -> dict:
        """Segment + integrate one depth-camera frame at `pose`
        (cam_T_world); returns the integrate stats as ints."""
        tsdf = self.cfg.tsdf
        if pose is None:
            raise ValueError("no pose: tracking is not ported, pass cam_T_world")
        if rgb.shape[:2] != (tsdf.height, tsdf.width) or depth.shape != (tsdf.height, tsdf.width):
            raise ValueError(
                f"frame is {tuple(depth.shape)}, the map is fed "
                f"{(tsdf.height, tsdf.width)}; resizing is not ported yet"
            )
        if ht is None or lt is None:
            ht, lt = self.seg.infer_one(rgb)
        pose = SE3(pose.R.to(self.device, torch.float32), pose.t.to(self.device, torch.float32))
        with self._lock:
            self.map, stats = integrate_frame(
                self.map,
                self._tensor(rgb), self._tensor(depth), self._tensor(ht), self._tensor(lt),
                self.tsdf_cam, pose, tsdf, alloc_stride=self.alloc_stride,
            )
            self.num_integrated += 1
            self.last_stats = {k: int(v) for k, v in stats.items()}
            return self.last_stats

    def query_tsdf(self, lo, hi) -> np.ndarray:
        """(x, y, z, tsdf) rows inside the AABB (planner API)."""
        with self._lock:
            return query_tsdf(self.map, self.cfg.tsdf, lo, hi)

    def download_all(self, path: str) -> int:
        with self._lock:
            return dump_semantic_tsdf(self.map, self.cfg.tsdf, path)

    def semantic_voxels(self) -> np.ndarray:
        with self._lock:
            return gather_valid_semantic(self.map, self.cfg.tsdf)

    def synchronize(self) -> None:
        """Wait for the device work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
