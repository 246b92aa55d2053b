"""The live pipeline of the PyTorch port (ra_slam_tpu_torch/pipeline/
live.py) driven by tests/test_live.py's fake cameras at 240x180 on the
CPU: both threads make progress, poses reach the buffer, frames fuse at
the tracked poses and a preview PNG decodes; a camera fault stops the
session and is re-raised; `main` wires the rectifier, the config and
`--device` through to the facade; `ZedDepthCamera` (io/cameras.py)
computes its depth with `dense_stereo_depth` on its device and hands it
over there."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads)
from ra_slam_tpu_torch.core.config import CameraConfig, FeatureConfig, SystemConfig, TrackingConfig, TsdfConfig
from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
from ra_slam_tpu_torch.features.stereo import dense_stereo_depth
from ra_slam_tpu_torch.io import cameras
from ra_slam_tpu_torch.io.png import read_png
from ra_slam_tpu_torch.pipeline import live
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
from test_live import FakeRGBDCam, FakeStereoCam
from test_stereo import BASELINE, FXB, SPEC, _stereo_pair

FRAMES = 4


def _cfg():
    return SystemConfig(
        camera=CameraConfig(fx=SPEC.fx, fy=SPEC.fy, cx=SPEC.cx, cy=SPEC.cy, width=SPEC.width, height=SPEC.height,
                            focal_x_baseline=FXB),
        tsdf=TsdfConfig(voxel_size=0.05, truncation=0.3, max_depth=6.0, log2_num_blocks=12, log2_hash_size=14,
                        max_visible_blocks=1024, width=SPEC.width, height=SPEC.height, raycast_min_weight=1.0),
        feature=FeatureConfig(max_num_keypoints=300, num_levels=3),
        tracking=TrackingConfig(min_inliers=10, match_radius=30.0),
    )


def test_live_run_threads(tmp_path):
    system = RaSlamSystem(_cfg(), "cpu", segmentation_model=None)
    n_previews, n_slam, n_tsdf = live.run(system, FakeStereoCam(), FakeRGBDCam(system), out_dir=str(tmp_path),
                                          render_every_s=1.0, stop_after_frames=FRAMES)
    assert n_slam >= FRAMES and n_tsdf >= FRAMES
    assert len(system.slam.pose_buffer) > 0 and system.num_integrated > 0
    assert n_previews >= 1
    png = read_png(str(tmp_path / "live_00000.png"))
    assert png.shape == (SPEC.height, SPEC.width, 4) and png.dtype == np.uint8


class _BrokenCam:
    def get_stereo_frame(self):
        raise OSError("usb unplugged")


def test_camera_fault_stops_and_reraises():
    system = RaSlamSystem(_cfg(), "cpu", segmentation_model=None)
    with pytest.raises(RuntimeError, match="camera thread 'slam' failed: usb unplugged"):
        live.run(system, _BrokenCam(), FakeRGBDCam(), stop_after_frames=FRAMES)


class _FakeZed:
    """`ZedNativeCamera`'s interface over tests/test_stereo.py's pairs."""

    def __init__(self, rectifier=None, device_id=0, *args):
        self.rectifier, self.i, self.closed = rectifier, 0, False

    def get_stereo_frame(self):
        left, right, _, _ = _stereo_pair((0.3 - 0.01 * self.i, 0.005 * self.i, 0.01 * self.i))
        self.i += 1
        if self.rectifier is not None:
            left, right = self.rectifier.rectify(left, right)
        return left, right, self.i / 30.0

    def close(self):
        self.closed = True


def test_zed_depth_camera_computes_dense_depth():
    cam = cameras.ZedDepthCamera(None, FXB, max_disparity=32, device="cpu", cam=_FakeZed())
    (left, right, ts), (rgb, depth, ts2) = cam.get_stereo_and_rgbd_frame()
    assert ts == ts2 and rgb is left and isinstance(depth, torch.Tensor) and depth.device == cam.device
    assert depth.dtype == torch.float32 and depth.shape == left.shape[:2] and left.dtype == torch.uint8
    g = lambda a: rgb_to_gray(torch.as_tensor(a))
    want, valid = dense_stereo_depth(g(left), g(right), FXB, max_disparity=32, max_depth=10.0)
    torch.testing.assert_close(depth, want, rtol=0, atol=0)
    assert valid.float().mean() > 0.3
    cam.close()
    assert cam.cam.closed


def test_zed_depth_camera_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cameras.ZedDepthCamera(None, FXB, cam=_FakeZed())


# the RealSense's colour stream in the fakes: the frames FakeRGBDCam
# delivers (the left view of tests/test_stereo.py's pairs)
RS_CAMERA = CameraConfig(fx=SPEC.fx, fy=SPEC.fy, cx=SPEC.cx, cy=SPEC.cy, width=SPEC.width, height=SPEC.height)
# a depth camera apart from the ZED: other intrinsics at the same size
DEPTH_CAMERA = CameraConfig(fx=150.0, fy=151.0, cx=121.5, cy=88.0, width=SPEC.width, height=SPEC.height)


def _live_main(tmp_path, monkeypatch, extra=(), rs_camera=RS_CAMERA, frames=None):
    """`live.main --device cpu --duration 1.0` on a config holding an
    identity stereo calibration (and the lines `extra`), with fake cameras
    in place of the drivers; with `frames`, `run` ends the session once
    both threads have fed that many frames, not on the clock. Returns
    (the system `run` was given, the fakes)."""
    text = "\n".join([
        f"Camera.fx: {SPEC.fx}", f"Camera.fy: {SPEC.fy}", f"Camera.cx: {SPEC.cx}", f"Camera.cy: {SPEC.cy}",
        f"Camera.cols: {SPEC.width}", f"Camera.rows: {SPEC.height}",
        *[f"Calibration.{s}.{k}: {v}" for s in ("left", "right")
          for k, v in (("fx", SPEC.fx), ("fy", SPEC.fy), ("cx", SPEC.cx), ("cy", SPEC.cy))],
        "Calibration.left.distortion: [0.0, 0.0, 0.0, 0.0, 0.0]",
        "Calibration.right.distortion: [0.0, 0.0, 0.0, 0.0, 0.0]",
        "Calibration.rotation: [0.0, 0.0, 0.0]", f"Calibration.translation: [{-BASELINE}, 0.0, 0.0]",
        *extra,
        "tsdf:", "  voxel_size: 0.05", "  truncation: 0.3", "  log2_num_blocks: 12", "  log2_hash_size: 14",
        "  max_visible_blocks: 1024", f"  width: {SPEC.width}", f"  height: {SPEC.height}",
        "Feature:", "  max_num_keypoints: 300", "  num_levels: 3",
    ]) + "\n"
    cfg_path = tmp_path / "live.yaml"
    cfg_path.write_text(text)
    made = {}

    def fake_zed(rectifier, device_id=0):
        made["zed"] = _FakeZed(rectifier)
        return made["zed"]

    class FakeRealSense(FakeRGBDCam):
        camera = rs_camera

        def __init__(self):
            super().__init__()
            made["rs"] = self

        def close(self):
            made["rs_closed"] = True

    monkeypatch.setattr(cameras, "ZedNativeCamera", fake_zed)
    monkeypatch.setattr(cameras, "RealSenseCamera", FakeRealSense)
    seen = {}
    saved = live.run

    def spy(system, stereo, rgbd, **kw):
        seen["system"] = rgbd.system = system  # its first frame waits for a tracked pose
        if frames is not None:
            kw.update(stop_after_frames=frames, stop_after_s=None)
        return saved(system, stereo, rgbd, **kw)

    monkeypatch.setattr(live, "run", spy)
    live.main(["--config", str(cfg_path), "--device", "cpu", "--duration", "1.0", "--out", str(tmp_path / "v")])
    return seen["system"], made


def _tsdf_cam_of(c: CameraConfig):
    from ra_slam_tpu_torch.core.camera import PinholeCamera

    return PinholeCamera.create(c.fx, c.fy, c.cx, c.cy, c.width, c.height).resized(SPEC.width, SPEC.height)


def test_main_wires_config_rectifier_and_device(tmp_path, monkeypatch, capsys):
    """`live.main --device cpu` with fake cameras: the rectifier, the
    config and the device reach the facade; the RGB-D frames are fused
    with the RealSense's own intrinsics."""
    system, made = _live_main(tmp_path, monkeypatch)
    assert system.device.type == "cpu" and made["zed"].closed and made["rs_closed"]
    assert made["zed"].rectifier.device.type == "cpu"
    assert system.cfg.camera.focal_x_baseline == pytest.approx(FXB, rel=1e-6)
    assert system.cfg.depth_camera == RS_CAMERA and system.tsdf_cam == _tsdf_cam_of(RS_CAMERA)
    assert "live session done" in capsys.readouterr().out


@pytest.mark.parametrize("source", ["config_section", "realsense_stream"])
def test_main_fuses_with_the_depth_camera(tmp_path, monkeypatch, source):
    """A depth camera apart from the tracking camera: `main` rewrites the
    tracking camera to the rectified ZED and fuses the RGB-D frames with
    the depth camera's intrinsics, from the config's `DepthCamera`
    section or else from the RealSense's stream; frames fuse through
    `live.run`'s two threads. The session ends after two frames of each
    camera, not on the clock: the first stereo pair alone takes seconds
    on a loaded CPU, and a frame the clock cuts off is never fused."""
    if source == "config_section":
        d = DEPTH_CAMERA
        extra = [f"DepthCamera.{k}: {v}" for k, v in (("fx", d.fx), ("fy", d.fy), ("cx", d.cx), ("cy", d.cy),
                                                      ("cols", d.width), ("rows", d.height))]
        system, _ = _live_main(tmp_path, monkeypatch, extra, frames=2)
        assert system.cfg.depth_camera == dataclasses.replace(DEPTH_CAMERA, depthmap_factor=5000.0)
    else:
        system, _ = _live_main(tmp_path, monkeypatch, rs_camera=DEPTH_CAMERA, frames=2)
        assert system.cfg.depth_camera == DEPTH_CAMERA
    assert system.tsdf_cam == _tsdf_cam_of(DEPTH_CAMERA)
    assert system.cfg.camera.fx != DEPTH_CAMERA.fx
    assert system.cfg.camera.focal_x_baseline == pytest.approx(FXB, rel=1e-6)
    assert system.num_integrated > 0
