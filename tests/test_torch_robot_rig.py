"""The robot's rig in the PyTorch port held against the benchmark's plain
reference (`benchmark/reference/rig.py`), on the CPU at small sizes:

- `load_yaml_config` reads a `DepthCamera` section (nested or flat) and
  the extrinsics; without the section `depth_camera` is None;
- without a depth camera the facade's `tsdf_cam` is the tracking
  camera's, as before; with one, the depth camera's;
- `StereoRectifier.rectify` against the reference's remap of the same
  calibration (Bouguet, zero disparity, alpha 0, written apart);
- `feed_rgbd_frame(pose=None)` between two tracked poses fuses at the
  reference's slerp composed with the extrinsics;
- a frame fused with a depth camera apart from the tracking camera, on
  seeded UNet weights, gives the reference's map.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from benchmark.harness import scene, weights
from benchmark.reference import compare, fusion, rig
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import CameraConfig, SystemConfig, TrackingConfig, TsdfConfig, load_yaml_config
from ra_slam_tpu_torch.core.rectify import CalibMono, CalibStereo, StereoRectifier
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
from ra_slam_tpu_torch.utils import pose_buffer
from ra_slam_tpu_torch.utils.profiling import TRACE

# the ZED at a third of its VGA size, the calibration of
# benchmark/configs/zed_l515_robot.json scaled with it
ZED_SIZE = (224, 128)
LEFT = dict(fx=116.61, fy=116.65, cx=112.64, cy=62.29, distortion=[-0.1719, 0.0257, 0.00031, -0.00024, 0.0])
RIGHT = dict(fx=116.76, fy=116.77, cx=111.15, cy=61.59, distortion=[-0.1693, 0.0249, -0.00018, 0.00036, 0.0])
ROTATION, TRANSLATION = [0.0031, -0.0046, 0.0012], [-0.12, 0.00021, -0.00043]
# the L515 at a quarter of 1280x720, fused at 160x90
L515 = CameraConfig(fx=227.03, fy=226.9, cx=160.8, cy=89.6, width=320, height=180, fps=30.0,
                    depthmap_factor=4000.0)
TSDF = TsdfConfig(voxel_size=0.04, truncation=0.24, max_depth=4.0, log2_num_blocks=13, log2_hash_size=15,
                  max_visible_blocks=2048, max_new_blocks=4096, width=160, height=90)
L515_T_ZED = np.array([[0.999906985884, 0.005885707547, 0.012303577824, -0.060310150627],
                       [-0.006311437731, 0.99937246343, 0.034854627978, -0.084045153708],
                       [-0.012090712732, -0.034929039271, 0.99931665496, 0.018684160926],
                       [0.0, 0.0, 0.0, 1.0]])
ZED = CameraConfig(fx=120.0, fy=120.0, cx=111.5, cy=63.5, width=224, height=128, focal_x_baseline=14.4)


def _yaml(style: str) -> str:
    lines = ["Camera.fx: 120.0", "Camera.fy: 120.0", "Camera.cx: 111.5", "Camera.cy: 63.5", "Camera.cols: 224",
             "Camera.rows: 128", "depthmap_factor: 5000.0",
             "Extrinsics: [" + ", ".join(repr(float(v)) for v in L515_T_ZED.ravel()) + "]"]
    d = dict(fx=L515.fx, fy=L515.fy, cx=L515.cx, cy=L515.cy, cols=L515.width, rows=L515.height, fps=L515.fps,
             depthmap_factor=L515.depthmap_factor)
    if style == "nested":
        lines += ["DepthCamera:"] + [f"  {k}: {v}" for k, v in d.items()]
    elif style == "flat":
        lines += [f"DepthCamera.{k}: {v}" for k, v in d.items()]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("style", ["nested", "flat", "none"])
def test_load_yaml_config_reads_the_depth_camera(style, tmp_path):
    path = tmp_path / "rig.yaml"
    path.write_text(_yaml(style))
    cfg = load_yaml_config(str(path))
    assert cfg.depth_camera == (None if style == "none" else L515)
    assert (cfg.camera.fx, cfg.camera.width, cfg.camera.depthmap_factor) == (120.0, 224, 5000.0)
    np.testing.assert_array_equal(np.array(cfg.extrinsics, np.float64).reshape(4, 4), L515_T_ZED)


@pytest.mark.parametrize("depth_camera", [None, L515], ids=["tracking_camera", "depth_camera"])
def test_tsdf_cam_is_the_depth_cameras(depth_camera):
    """Without a depth camera `tsdf_cam` is the tracking camera's at the
    feed size, exactly as before the depth camera existed."""
    cfg = SystemConfig(camera=ZED, tsdf=TSDF, depth_camera=depth_camera)
    system = RaSlamSystem(cfg, "cpu", enable_tracking=False)
    c = depth_camera or ZED
    assert system.tsdf_cam == PinholeCamera.create(c.fx, c.fy, c.cx, c.cy, c.width, c.height).resized(160, 90)


@pytest.mark.parametrize("fxb", [0.0, 14.4, 60.0], ids=["rgbd", "zed", "wide_baseline"])
def test_stereo_depths_count_out_to_the_threshold(fxb, monkeypatch):
    """A stereo tracking camera's keypoint depths are dropped beyond
    STEREO_DEPTH_THRESHOLD baselines: the facade caps the tracker's
    max_depth there; an RGB-D tracking camera keeps it."""
    import ra_slam_tpu_torch.slam.system as slam_system
    from ra_slam_tpu_torch.pipeline.system import STEREO_DEPTH_THRESHOLD

    system = RaSlamSystem(SystemConfig(camera=dataclasses.replace(ZED, focal_x_baseline=fxb), tsdf=TSDF), "cpu")
    tmax = TrackingConfig().scaled(ZED.width / 320.0).max_depth
    want = min(tmax, STEREO_DEPTH_THRESHOLD * fxb / ZED.fx) if fxb else tmax
    assert system.slam.tcfg.max_depth == want and (fxb != 14.4 or want == pytest.approx(4.8))
    if not fxb:
        return
    seen = {}
    real = slam_system.stereo_keypoint_depth

    def spy(*a, **k):
        seen.update(k)
        return real(*a, **k)

    monkeypatch.setattr(slam_system, "stereo_keypoint_depth", spy)
    img = np.random.default_rng(0).integers(0, 256, (ZED.height, ZED.width, 3)).astype(np.uint8)
    system.feed_stereo_frame(img, img, 0.0)
    assert seen["max_depth"] == want


def _calib(c: dict) -> CalibMono:
    return CalibMono(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], distortion=c["distortion"])


def test_rectify_matches_the_reference():
    """The raw pair of a textured image through the port's rectifier and
    the reference's maps and bilinear remap: the maps within 1e-3 px
    (both float64 sums, stored in float32; the port rounds two of cv2's
    intermediates to float32), the images within 1 level (rounding of
    two float32 bilinear sums). The spans and the counter report the
    call."""
    rect = StereoRectifier(ZED_SIZE, CalibStereo(_calib(LEFT), _calib(RIGHT), ROTATION, TRANSLATION), "cpu")
    R1, R2, P1, P2 = rig.rectification(LEFT, RIGHT, ROTATION, TRANSLATION, ZED_SIZE)
    np.testing.assert_allclose(rect.cam_rect_matrix, P2, rtol=1e-6, atol=1e-5)
    rng = np.random.default_rng(4)
    raw = [rng.integers(0, 256, (ZED_SIZE[1] // 4, ZED_SIZE[0] // 4, 3)).astype(np.uint8).repeat(4, 0).repeat(4, 1)
           for _ in range(2)]
    before = TRACE.counters()["rectify.calls"]
    TRACE.enable()
    try:
        got = rect.rectify(*raw)
        recs = TRACE.drain()
    finally:
        TRACE.enable(False)
    assert TRACE.counters()["rectify.calls"] == before + 1
    assert {r.name for r in recs} == {"rectify.remap", "rectify.to_host"}
    for (mx, my), cam, R, P, img, out in zip(rect.maps, (LEFT, RIGHT), (R1, R2), (P1, P2), raw, got):
        rx, ry = rig.rectify_maps(cam, R, P, ZED_SIZE)
        assert max(np.abs(rx - mx).max(), np.abs(ry - my).max()) < 1e-3
        want = rig.remap(torch.from_numpy(img), torch.from_numpy(rx), torch.from_numpy(ry)).numpy()
        d = np.abs(out.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and d.mean() < 1e-3


def _cam_T_world(i: int) -> np.ndarray:
    """A tracked ZED pose of the walk: the benchmark's walk, inverted."""
    return np.linalg.inv(scene.walk(2400, (1.2, 0.8), 0.1)[i])


@pytest.mark.parametrize("t", [1 / 120, 0.0121, 1 / 60], ids=["midway", "off_centre", "at_a_pose"])
def test_rgbd_frame_fuses_at_the_reference_handoff(t):
    """Two tracked poses in the buffer at 0 and 1/60 s; a depth frame at
    `t` is fused at the slerp of the two composed with the extrinsics:
    the pose the facade fused at within 1e-6 of the reference's float64
    hand-off (the buffer's quaternions come from float32 rotations, the
    composition is float32). The counter counts the queries between the
    poses, not the one at a pose."""
    cfg = SystemConfig(camera=ZED, tsdf=TSDF, depth_camera=L515, extrinsics=L515_T_ZED.ravel().tolist())
    system = RaSlamSystem(cfg, "cpu")
    poses = [_cam_T_world(0), _cam_T_world(8)]  # 8 ticks of the walk apart: ~2 cm and 1.2 deg
    for stamp, m in zip((0.0, 1 / 60), poses):
        system.slam.pose_buffer.register(stamp, SE3.from_matrix(torch.as_tensor(m, dtype=torch.float32)))
    before = pose_buffer.INTERPOLATED
    depth = np.full((L515.height, L515.width), 1.5, np.float32)
    rgb = np.full((L515.height, L515.width, 3), 128, np.uint8)
    assert "skipped" not in system.feed_rgbd_frame(rgb, depth, t)
    got = np.eye(4)
    got[:3, :3], got[:3, 3] = system.last_pose.R.numpy(), system.last_pose.t.numpy()
    f32 = [m.astype(np.float32).astype(np.float64) for m in poses]
    want = rig.handoff([0.0, 1 / 60], f32, t, L515_T_ZED)
    assert np.abs(got - want).max() < 1e-6
    assert pose_buffer.INTERPOLATED - before == (0 < t < 1 / 60)


@pytest.fixture(scope="module")
def l515_frames():
    """Three L515 frames of the benchmark's room along the walk (colour
    uint8 and z16 depth) and their cam_T_world."""
    room = scene.make_room((3.0, 1.5, 2.5), 12)
    walk = scene.walk(2400, (1.2, 0.8), 0.1)
    wTc = walk[[1, 5, 9]] @ np.linalg.inv(L515_T_ZED)
    rgb, z = scene.render(room, torch.as_tensor(wTc), L515.fx, L515.fy, L515.cx, L515.cy, L515.width, L515.height)
    gen = torch.Generator().manual_seed(scene.seed_bits(11))
    z16 = scene.sensor_depth(z, torch.randn(z.shape, generator=gen), 0.001, L515.depthmap_factor)
    return rgb.numpy(), z16.numpy().astype(np.uint16), np.linalg.inv(wTc)


def test_depth_camera_frames_give_the_reference_map(l515_frames, tmp_path):
    """L515 frames fused by the facade (tracking camera: the ZED; depth
    camera: the L515; seeded UNet weights) at given poses, against the
    reference's replay of the same frames: the same blocks, tsdf and
    weight within tests/torch_parity.py's fusion bounds on every voxel of
    them (float32 fusion in other operation orders), prob within 0.007
    on the mean (the port's bfloat16 convolutions against the float32
    reference; the benchmark's `map_prob` limit), colour equal (both
    resize uint8 colour as cv2 does)."""
    rgb, z16, cTw = l515_frames
    wts = weights.make_weights((32, 64, 128, 256), 5, "cpu")
    ckpt = tmp_path / "seg.msgpack"
    ckpt.write_bytes(weights.checkpoint_bytes(wts))
    system = RaSlamSystem(SystemConfig(camera=ZED, tsdf=TSDF, depth_camera=L515), "cpu",
                          segmentation_model=str(ckpt), enable_tracking=False)
    f32 = lambda x: float(np.float32(x))
    fx, fy, cx, cy = rig.scaled_intrinsics(dataclasses.asdict(L515), (TSDF.width, TSDF.height))
    rm = fusion.RefMap(fusion.MapSpec(
        voxel_size=TSDF.voxel_size, truncation=TSDF.truncation, max_depth=TSDF.max_depth, min_depth=TSDF.min_depth,
        max_weight=TSDF.max_weight, carve_threshold=TSDF.carve_threshold, max_new_blocks=TSDF.max_new_blocks,
        max_visible_blocks=TSDF.max_visible_blocks, alloc_stride=2, fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
        width=TSDF.width, height=TSDF.height), "cpu")
    for k in range(len(cTw)):
        depth = z16[k].astype(np.float32) * np.float32(1 / L515.depthmap_factor)
        system.feed_rgbd_frame(rgb[k], depth, k / 30.0,
                               pose=SE3.from_matrix(torch.as_tensor(cTw[k], dtype=torch.float32)))
        c, d = rig.l515_frame(rgb[k], z16[k], 1 / L515.depthmap_factor, (TSDF.width, TSDF.height))
        ht, lt = rig.segment(wts, torch.from_numpy(c), 4)
        rm.integrate(torch.from_numpy(d), torch.from_numpy(c).float(), ht, lt,
                     torch.as_tensor(cTw[k], dtype=torch.float32))
    m = system.map
    idx = torch.nonzero(m.active).squeeze(1)
    keys = m.block_key[idx].to(torch.int64)
    order = torch.argsort(keys)
    rows = idx[order]
    prog = (keys[order], m.tsdf[rows], m.weight[rows], m.prob[rows], m.rgb[rows])
    ref = rm.blocks()
    assert torch.equal(prog[0], ref[0]) and len(ref[0]) > 50
    for a, b, name in zip(prog[1:3], ref[1:3], ("tsdf", "weight")):
        assert float((a - b).abs().max()) <= tp.TOL[name], name
    nums = compare.map_numbers(prog, ref)
    assert nums["map_prob"] <= 0.007 and nums["map_rgb"] == 0.0, nums

