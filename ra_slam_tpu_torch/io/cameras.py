"""Live camera drivers (counterpart of `ra_slam_tpu/io/cameras.py`).

RealSense RGB-D (L515 at 1280x720 colour + 640x480 depth aligned to
colour) through pyrealsense2, and the ZED as a UVC webcam (side-by-side
split + rectification) through `cv2.VideoCapture`. Each camera class imports
its SDK when it is built and raises a clear error without it; no camera
is needed anywhere else (the offline readers replay recorded data).
Pixels never go through cv2: a BGR frame becomes RGB by a numpy flip,
and rectification is `core/rectify.py`'s.

`ZedDepthCamera` plays the ZED SDK's depth engine: the rectified pair
feeds tracking, and the left image with `features/stereo.py:
dense_stereo_depth` of the pair, computed on `device`, feeds the TSDF.
"""

from __future__ import annotations

import importlib
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ra_slam_tpu_torch.core.device import resolve_device
from ra_slam_tpu_torch.core.rectify import StereoRectifier


def get_timestamp() -> float:
    """Monotonic seconds (reference `GetTimestamp`)."""
    return time.monotonic()


def get_system_timestamp() -> float:
    """Wall-clock seconds (reference `GetSystemTimestamp`)."""
    return time.time()


def require_sdk(module: str, why: str):
    """Import a camera SDK, or raise a RuntimeError that says who needs it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise RuntimeError(f"{why} needs {module}, which is not installed; "
                           "replay recorded data with the offline readers instead") from e


class RealSenseCamera:
    """L515 / SR300-style RGB-D capture through pyrealsense2:
    `get_rgbd_frame()` returns (rgb [H, W, 3] uint8, depth [H, W] float32
    meters aligned to colour, timestamp in seconds). `camera` is the
    intrinsics of those frames (the colour stream's, which the depth is
    aligned to) as a `CameraConfig`."""

    def __init__(self, color_size: Tuple[int, int] = (1280, 720), depth_size: Tuple[int, int] = (640, 480),
                 fps: int = 30):
        rs = require_sdk("pyrealsense2", "RealSenseCamera")
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.color, color_size[0], color_size[1], rs.format.rgb8, fps)
        cfg.enable_stream(rs.stream.depth, depth_size[0], depth_size[1], rs.format.z16, fps)
        profile = self.pipeline.start(cfg)
        self.depth_scale = float(profile.get_device().first_depth_sensor().get_depth_scale())
        self.align = rs.align(rs.stream.color)
        from ra_slam_tpu_torch.core.config import CameraConfig

        k = profile.get_stream(rs.stream.color).as_video_stream_profile().get_intrinsics()
        self.camera = CameraConfig(fx=k.fx, fy=k.fy, cx=k.ppx, cy=k.ppy, width=k.width, height=k.height,
                                   fps=float(fps), depthmap_factor=1.0 / self.depth_scale)

    def get_rgbd_frame(self) -> Tuple[np.ndarray, np.ndarray, float]:
        frames = self.align.process(self.pipeline.wait_for_frames())
        color = np.asanyarray(frames.get_color_frame().get_data())
        depth = np.asanyarray(frames.get_depth_frame().get_data()).astype(np.float32) * self.depth_scale
        return color, depth, frames.get_timestamp() * 1e-3  # ms -> s

    def close(self) -> None:
        self.pipeline.stop()


class ZedNativeCamera:
    """The ZED as a UVC webcam: side-by-side stereo split and
    rectification (reference `ZEDNative`)."""

    def __init__(self, rectifier: Optional[StereoRectifier], device_id: int = 0, width: int = 1344,
                 height: int = 376, fps: int = 60):
        cv2 = require_sdk("cv2", "ZedNativeCamera (cv2.VideoCapture)")
        self.cap = cv2.VideoCapture(device_id)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open video device {device_id}")
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        self.cap.set(cv2.CAP_PROP_FPS, fps)
        self.rectifier = rectifier

    def get_stereo_frame(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """(left, right, timestamp), rectified when a rectifier is set."""
        ok, frame = self.cap.read()
        ts = get_timestamp()
        if not ok:
            raise RuntimeError("frame grab failed")
        frame = np.ascontiguousarray(frame[..., ::-1])  # BGR -> RGB
        half = frame.shape[1] // 2
        left, right = frame[:, :half], frame[:, half:]
        if self.rectifier is not None:
            left, right = self.rectifier.rectify(left, right)
        return left, right, ts

    def close(self) -> None:
        self.cap.release()


class ZedDepthCamera:
    """ZED-SDK-style stereo RGB-D: raw UVC stereo capture and dense census
    disparity on `device`, returning (stereo pair, RGB-D frame) like
    `ZED::GetStereoAndRGBDFrame`. `cam` is the rectified stereo source
    (anything with `get_stereo_frame()` and `close()`); by default a
    `ZedNativeCamera` opened with the other arguments."""

    def __init__(self, rectifier, focal_x_baseline: float, device_id: int = 0, width: int = 1344,
                 height: int = 376, fps: int = 60, max_disparity: int = 64, max_depth: float = 10.0,
                 device="cuda", cam=None):
        self.device = resolve_device(device)  # raises for cuda without a card, before the camera opens
        self.focal_x_baseline = focal_x_baseline
        self.max_disparity, self.max_depth = max_disparity, max_depth
        self.cam = cam if cam is not None else ZedNativeCamera(rectifier, device_id, width, height, fps)

    def depth(self, left_rgb: np.ndarray, right_rgb: np.ndarray) -> np.ndarray:
        """[H, W] float32 depth in meters (0 where invalid) of a rectified
        RGB pair, computed on the camera's device."""
        from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
        from ra_slam_tpu_torch.features.stereo import dense_stereo_depth

        t = lambda a: rgb_to_gray(torch.as_tensor(np.ascontiguousarray(a)).to(self.device))
        d, _ = dense_stereo_depth(t(left_rgb), t(right_rgb), self.focal_x_baseline,
                                  max_disparity=self.max_disparity, max_depth=self.max_depth)
        return d.cpu().numpy()

    def get_stereo_and_rgbd_frame(self):
        """((left, right, t_stereo), (rgb, depth, t_rgbd)): the pair feeds
        tracking, the left image and its dense depth the TSDF."""
        left, right, ts = self.cam.get_stereo_frame()
        return (left, right, ts), (left, self.depth(left, right), ts)

    def close(self) -> None:
        self.cam.close()
