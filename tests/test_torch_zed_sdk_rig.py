"""The ZED alone as the RGB-D camera in the PyTorch port, on the CPU at
small sizes:

- `features/stereo.py:dense_stereo_depth` against the benchmark's plain
  reference (`benchmark/reference/dense_stereo.py`, written apart) on
  seeded textured pairs, and a fault (the left-right check skipped) that
  the comparison catches;
- `feed_rgbd_frame` fed tensors (colour and depth already on a device)
  gives the numpy-fed map bit for bit;
- `load_yaml_config` of a ZED-SDK YAML: the dense settings and the
  tracking camera as the depth camera; the keypoint search range the
  facade computes from the camera's focal_x_baseline;
- `live.run` with one fake ZED fuses every tracked pair at its own pose,
  with no interpolated query, and no pair that lost tracking, though the
  tracker runs ahead of the mapping thread; `live.main` builds that rig
  from its YAML without a RealSense;
- the dense stage's spans and counters: recorded when on, the shared
  no-op when off, `ra.` ranges under a profiler.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parity  # noqa: F401  (torch threads)
from benchmark.reference import dense_stereo as ref
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import (CameraConfig, DenseStereoConfig, FeatureConfig, SystemConfig,
                                           TrackingConfig, TsdfConfig, load_yaml_config)
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.features import stereo
from ra_slam_tpu_torch.io import cameras
from ra_slam_tpu_torch.pipeline import live
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem, keypoint_search_range
from ra_slam_tpu_torch.utils import pose_buffer, profiling
from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy
from ra_slam_tpu_torch.utils.profiling import TRACE
from test_stereo import BASELINE, FXB, SPEC
from test_torch_live import _FakeZed


def _textured_pair(h: int, w: int, dmax: int, seed: int):
    """Integer gray levels (ties included) of a seeded smoothed texture;
    the right view's column u sees the left view's column u + disparity,
    the disparity varying by column band."""
    g = torch.Generator().manual_seed(seed)
    tex = torch.rand((1, 1, h, w + 2 * dmax), generator=g) * 255
    tex = torch.round(F.avg_pool2d(tex, 3, 1, 1, count_include_pad=False))[0, 0]
    u = torch.arange(w)
    disp = 3 + (u // 17 * 7) % (dmax - 6)
    return tex[:, dmax:dmax + w], tex[:, dmax + u + disp]


SHAPES = [(96, 160, 32, 11), (83, 149, 24, 12)]  # (H, W, D, seed): the cell's small shape and an odd one


@pytest.mark.parametrize("h,w,d,seed", SHAPES, ids=["160x96", "149x83"])
def test_dense_stereo_matches_the_reference(h, w, d, seed):
    gl, gr = _textured_pair(h, w, d, seed)
    got_d, got_v = stereo.dense_stereo_depth(gl, gr, 40.0, max_disparity=d, max_depth=20.0)
    want_d, want_v = ref.depth(gl, gr, 40.0, d, max_depth=20.0, rows=16)
    assert got_v.float().mean() > 0.3
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=0)


def test_reference_rows_do_not_change_it():
    gl, gr = _textured_pair(96, 160, 32, 11)
    a = ref.depth(gl, gr, 40.0, 32, rows=7)
    b = ref.depth(gl, gr, 40.0, 32, rows=96)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_skipped_left_right_check_fails_the_comparison(monkeypatch):
    monkeypatch.setattr(stereo, "_left_right_ok", lambda agg, u, d, best: torch.ones_like(best, dtype=torch.bool))
    gl, gr = _textured_pair(96, 160, 32, 11)
    got = stereo.dense_stereo_depth(gl, gr, 40.0, max_disparity=32, max_depth=20.0)[1]
    want = ref.depth(gl, gr, 40.0, 32, max_depth=20.0)[1]
    assert (got != want).float().mean() > 0.01


def test_popcount_table_is_made_once_per_device(monkeypatch):
    x = torch.tensor([7, 0xFFFFFF], dtype=torch.int32)
    stereo._popcount(x)
    made = []
    real = torch.tensor
    monkeypatch.setattr(stereo.torch, "tensor", lambda *a, **k: made.append(1) or real(*a, **k))
    assert stereo._popcount(x).tolist() == [3, 24]
    assert made == []


# --- the facade with the ZED's own depth

ZED = CameraConfig(fx=140.0, fy=140.0, cx=79.5, cy=47.5, width=160, height=96, focal_x_baseline=16.8)
TSDF = TsdfConfig(voxel_size=0.04, truncation=0.24, max_depth=4.0, log2_num_blocks=12, log2_hash_size=14,
                  max_visible_blocks=2048, max_new_blocks=4096, width=80, height=48)


def _frame(seed: int):
    g = torch.Generator().manual_seed(seed)
    rgb = (torch.rand((96, 160, 3), generator=g) * 255).to(torch.uint8)
    depth = 1.0 + 2.0 * torch.rand((96, 160), generator=g)
    depth[torch.rand((96, 160), generator=g) < 0.2] = 0.0
    return rgb, depth


def test_device_depth_fuses_as_numpy_depth():
    """Colour and depth handed over as tensors (the ZED's dense depth
    never leaves the device) give the numpy-fed map bit for bit, resized
    from the ZED's size to the feed size on the device."""
    cfg = SystemConfig(camera=ZED, tsdf=TSDF, dense_stereo=DenseStereoConfig(max_disparity=32))
    maps = []
    for as_tensor in (False, True):
        system = RaSlamSystem(cfg, "cpu", enable_tracking=False)
        for k in range(3):
            rgb, depth = _frame(k)
            if not as_tensor:
                rgb, depth = rgb.numpy(), depth.numpy()
            pose = SE3(torch.eye(3), torch.tensor([0.02 * k, 0.0, 0.0]))
            system.feed_rgbd_frame(rgb, depth, 0.1 * k, pose=pose)
        maps.append(voxel_map_to_numpy(system.map))
    assert (maps[0].tsdf > -1).any()
    for name, a in vars(maps[0]).items():
        if name == "table":
            np.testing.assert_array_equal(a.key, maps[1].table.key)
            np.testing.assert_array_equal(a.value, maps[1].table.value)
        else:
            np.testing.assert_array_equal(a, getattr(maps[1], name), err_msg=name)


ZED_SDK_YAML = """\
Camera.fx: 140.0
Camera.fy: 140.0
Camera.cx: 79.5
Camera.cy: 47.5
Camera.cols: 160
Camera.rows: 96
Camera.fps: 60
Camera.focal_x_baseline: {fxb}
{dense}
"""
DENSE = dict(max_disparity=192, max_depth=20.0)


@pytest.mark.parametrize("style", ["nested", "flat"])
def test_load_yaml_config_reads_the_zed_sdk_rig(style, tmp_path):
    dense = ("DenseStereo:\n" + "".join(f"  {k}: {v}\n" for k, v in DENSE.items()) if style == "nested"
             else "".join(f"DenseStereo.{k}: {v}\n" for k, v in DENSE.items()))
    path = tmp_path / "zed_sdk.yaml"
    path.write_text(ZED_SDK_YAML.format(dense=dense, fxb=80.98))  # HD720's fx b
    cfg = load_yaml_config(str(path))
    assert cfg.dense_stereo == DenseStereoConfig(**DENSE)
    assert cfg.depth_camera is None and cfg.extrinsics is None
    system = RaSlamSystem(cfg, "cpu")
    c = cfg.camera
    assert system.tsdf_cam == PinholeCamera.create(c.fx, c.fy, c.cx, c.cy, c.width, c.height).resized(640, 480)
    assert system.slam.max_disparity == 128


def test_defaults_keep_the_old_search_and_no_dense_stereo(tmp_path):
    path = tmp_path / "plain.yaml"
    path.write_text(ZED_SDK_YAML.format(dense="", fxb=40.29))  # the robot's ZED at 672x376
    cfg = load_yaml_config(str(path))
    assert cfg.dense_stereo is None
    assert RaSlamSystem(cfg, "cpu").slam.max_disparity == 64


@pytest.mark.parametrize("fxb,want", [(0.0, 64), (16.8, 64), (40.29, 64), (44.7, 64), (44.9, 96), (80.98, 128),
                                      (89.5, 128), (89.7, 160)])
def test_keypoint_search_range_reaches_the_least_depth(fxb, want):
    """Keypoint depths are searched from ~0.7 m: the range rounds
    fx b / 0.7 up to a multiple of 32, and keeps the old 64 below it."""
    got = keypoint_search_range(fxb)
    assert got == want
    assert fxb / got <= 0.7 and (got == 64 or fxb / (got - 32) > 0.7)


@pytest.mark.parametrize("extra", [dict(depth_camera=ZED), dict(extrinsics=np.eye(4).ravel().tolist())],
                         ids=["depth_camera", "extrinsics"])
def test_dense_stereo_refuses_another_depth_camera(extra):
    with pytest.raises(ValueError, match="dense_stereo"):
        RaSlamSystem(SystemConfig(camera=ZED, tsdf=TSDF, dense_stereo=DenseStereoConfig(), **extra), "cpu",
                     enable_tracking=False)


# --- the live rig with one camera

def _live_cfg():
    return SystemConfig(
        camera=CameraConfig(fx=SPEC.fx, fy=SPEC.fy, cx=SPEC.cx, cy=SPEC.cy, width=SPEC.width, height=SPEC.height,
                            focal_x_baseline=FXB),
        tsdf=TsdfConfig(voxel_size=0.05, truncation=0.3, max_depth=6.0, log2_num_blocks=12, log2_hash_size=14,
                        max_visible_blocks=1024, width=SPEC.width, height=SPEC.height, raycast_min_weight=1.0),
        feature=FeatureConfig(max_num_keypoints=300, num_levels=3),
        tracking=TrackingConfig(min_inliers=10, match_radius=30.0),
        dense_stereo=DenseStereoConfig(max_disparity=32),
    )


def test_live_run_fuses_every_tracked_pair_at_its_own_pose():
    system = RaSlamSystem(_live_cfg(), "cpu", segmentation_model=None)
    zed = cameras.ZedDepthCamera(None, FXB, device="cpu", cam=_FakeZed(), max_disparity=32)
    fused, real = [], system.feed_rgbd_frame

    def feed(rgb, depth, ts, *a, **k):
        assert isinstance(depth, torch.Tensor) and depth.shape == (SPEC.height, SPEC.width)
        stats = real(rgb, depth, ts, *a, **k)
        if "skipped" not in stats:
            fused.append((ts, system.last_pose))
        return stats

    system.feed_rgbd_frame = feed
    before = pose_buffer.INTERPOLATED
    _, n_slam, n_tsdf = live.run(system, zed, None, stop_after_frames=3)
    assert n_slam >= 3 and n_tsdf >= 3
    tracked = dict((ts, p) for ts, p in system.slam.pose_buffer.entries())
    assert len(fused) == system.num_integrated == len(tracked) >= 2
    for ts, pose in fused:
        np.testing.assert_allclose(pose.R.numpy(), tracked[ts].R.numpy(), atol=1e-6)
        np.testing.assert_allclose(pose.t.numpy(), tracked[ts].t.numpy(), atol=1e-6)
    assert pose_buffer.INTERPOLATED == before


class _BlankAt(_FakeZed):
    """tests/test_stereo.py's pairs, with a featureless pair at `blank`:
    tracking is lost there."""

    def __init__(self, blank: int):
        super().__init__()
        self.blank = blank

    def get_stereo_frame(self):
        left, right, ts = super().get_stereo_frame()
        if self.i - 1 == self.blank:
            left, right = np.full_like(left, 128), np.full_like(right, 128)
        return left, right, ts


def test_live_run_fuses_no_lost_pair_while_the_tracker_runs_ahead():
    """A pair that lost tracking is passed over, and each tracked pair is
    fused at its own tracked pose, though the mapping thread lags the
    tracker by several pairs (a lost pair taken after the tracker
    recovered, or a tracked one after a later loss, is judged by its own
    result, not by the tracker's state then)."""
    import time

    frames = 6
    system = RaSlamSystem(_live_cfg(), "cpu", segmentation_model=None)
    zed = cameras.ZedDepthCamera(None, FXB, device="cpu", cam=_BlankAt(2), max_disparity=32)
    results, fused = {}, []
    real_stereo, real_rgbd = system.feed_stereo_frame, system.feed_rgbd_frame

    def feed_stereo(left, right, ts, *a, **k):
        info = real_stereo(left, right, ts, *a, **k)
        results[ts] = (bool(info.tracked), info.pose)
        return info

    def feed_rgbd(rgb, depth, ts, *a, **k):
        time.sleep(0.3)  # the mapping thread lags
        stats = real_rgbd(rgb, depth, ts, *a, **k)
        assert "skipped" not in stats
        fused.append((ts, system.last_pose))
        return stats

    system.feed_stereo_frame, system.feed_rgbd_frame = feed_stereo, feed_rgbd
    before = pose_buffer.INTERPOLATED
    _, n_slam, n_tsdf = live.run(system, zed, None, stop_after_frames=frames)
    assert n_slam == n_tsdf == frames == len(results)
    tracked = {ts for ts, (ok, _) in results.items() if ok}
    assert not results[3 / 30.0][0] and len(tracked) >= 2  # the blank pair (the third) is lost
    assert [ts for ts, _ in fused] == sorted(tracked) and system.num_integrated == len(tracked)
    for ts, pose in fused:
        assert torch.equal(pose.R, results[ts][1].R) and torch.equal(pose.t, results[ts][1].t)
    assert pose_buffer.INTERPOLATED == before


def test_live_main_builds_the_zed_alone(tmp_path, monkeypatch, capsys):
    """`live.main` on a config with a `DenseStereo` section opens the ZED
    raw at twice the rectified width, opens no RealSense, and fuses the
    pairs with the rectified left camera."""
    lines = [f"Camera.fx: {SPEC.fx}", f"Camera.fy: {SPEC.fy}", f"Camera.cx: {SPEC.cx}", f"Camera.cy: {SPEC.cy}",
             f"Camera.cols: {SPEC.width}", f"Camera.rows: {SPEC.height}", "Camera.fps: 60",
             "Camera.max_disparity: 32",
             *[f"Calibration.{s}.{k}: {v}" for s in ("left", "right")
               for k, v in (("fx", SPEC.fx), ("fy", SPEC.fy), ("cx", SPEC.cx), ("cy", SPEC.cy))],
             "Calibration.left.distortion: [0.0, 0.0, 0.0, 0.0, 0.0]",
             "Calibration.right.distortion: [0.0, 0.0, 0.0, 0.0, 0.0]",
             "Calibration.rotation: [0.0, 0.0, 0.0]", f"Calibration.translation: [{-BASELINE}, 0.0, 0.0]",
             "DenseStereo:", "  max_disparity: 32", "  max_depth: 10.0",
             "tsdf:", "  voxel_size: 0.05", "  truncation: 0.3", "  log2_num_blocks: 12", "  log2_hash_size: 14",
             "  max_visible_blocks: 1024", f"  width: {SPEC.width}", f"  height: {SPEC.height}",
             "Feature:", "  max_num_keypoints: 300", "  num_levels: 3"]
    path = tmp_path / "zed_sdk.yaml"
    path.write_text("\n".join(lines) + "\n")
    made = {}

    def fake_zed(rectifier, device_id, width, height, fps):
        made.update(raw=(width, height, fps), zed=_FakeZed(rectifier))
        return made["zed"]

    def no_realsense(*a, **k):
        raise AssertionError("a RealSense was opened")

    monkeypatch.setattr(cameras, "ZedNativeCamera", fake_zed)
    monkeypatch.setattr(cameras, "RealSenseCamera", no_realsense)
    seen, saved = {}, live.run

    def spy(system, stereo_cam, rgbd_cam, **kw):
        seen.update(system=system, rgbd=rgbd_cam)
        return saved(system, stereo_cam, rgbd_cam, **dict(kw, stop_after_frames=2, stop_after_s=None))

    monkeypatch.setattr(live, "run", spy)
    live.main(["--config", str(path), "--device", "cpu", "--duration", "1.0"])
    system = seen["system"]
    assert seen["rgbd"] is None and made["raw"] == (2 * SPEC.width, SPEC.height, 60)
    assert made["zed"].rectifier is None and made["zed"].closed
    assert system.cfg.dense_stereo == DenseStereoConfig(max_disparity=32, max_depth=10.0)
    assert system.cfg.depth_camera is None and system.slam.max_disparity == 64
    assert system.cfg.camera.focal_x_baseline == pytest.approx(FXB, rel=1e-6)
    assert system.num_integrated > 0 and "live session done" in capsys.readouterr().out


# --- spans and counters

DENSE_SPANS = ["stereo.census", "stereo.cost", "stereo.aggregate", "stereo.select"]


def test_dense_spans_and_counters_when_on():
    gl, gr = _textured_pair(48, 96, 16, 5)
    calls, entries = stereo.DENSE_CALLS, stereo.DENSE_ENTRIES
    TRACE.drain()
    TRACE.enable()
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            stereo.dense_stereo_depth(gl, gr, 40.0, max_disparity=16)
        recs = TRACE.drain()
    finally:
        TRACE.enable(False)
    assert [r.path() for r in recs] == [f"stereo.dense/{n}" for n in DENSE_SPANS] + ["stereo.dense"]
    names = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    assert {"ra.stereo.dense"} | {f"ra.{n}" for n in DENSE_SPANS} <= names
    c = TRACE.counters()
    assert c["stereo.dense_calls"] == calls + 1 and c["stereo.dense_entries"] == entries + 48 * 96 * 16


def test_dense_spans_cost_nothing_when_off(monkeypatch):
    """Off, the dense stage reads no clock and records nothing; the
    counters still count."""
    assert not TRACE.enabled

    def forbidden(*a):
        raise AssertionError("read while the registry is off")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", forbidden)
    calls = stereo.DENSE_CALLS
    gl, gr = _textured_pair(48, 96, 16, 5)
    stereo.dense_stereo_depth(gl, gr, 40.0, max_disparity=16)
    assert TRACE.drain() == [] and stereo.DENSE_CALLS == calls + 1
