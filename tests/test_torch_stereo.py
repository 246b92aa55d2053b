"""Stereo keypoint tracking of the PyTorch port
(ra_slam_tpu_torch/features/stereo.py, SlamSystem.feed_stereo_frame)
against the JAX package on the CPU.

The pair is tests/test_stereo.py's: the synthetic box room rendered at
240x180 from a left camera and from the same camera moved 0.12 m along
its x axis, so the pair is rectified by construction. The JAX side runs
op by op (see tests/torch_parity.py).

The stereo witness: both packages' `feed_stereo_frame` stepped over six
pairs at the robot's pace (the ZED's 672x376 halved; the clutter room,
~0.5 cm and 0.3 deg a pair), the two states compared after every pair
by `scripts/lockstep_torch_jax.py:compare`: every discrete field of the
feedback and every integer field of the state exactly, poses within
1e-5, landmark points 2e-5 and stored pixels 1e-3 (the lockstep bounds).
It shares the system test's configuration, so that the JAX package's op
by op compiles of the SLAM step are made once in the file's process. The
gated witness steps the same pairs with the tracker's max_depth (which
gates stereo keypoint depths) inside the room.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.core.camera import PinholeCamera as JaxCamera
from ra_slam_tpu.core.config import FeatureConfig as JaxFeatureConfig
from ra_slam_tpu.core.config import TrackingConfig as JaxTrackingConfig
from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu.features import stereo as jst
from ra_slam_tpu.io.synthetic import SyntheticCameraSpec, look_at, render_box_room
from ra_slam_tpu.slam.system import SlamSystem as JaxSlamSystem
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import FeatureConfig, TrackingConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.features import stereo as tst
from ra_slam_tpu_torch.slam.system import SlamSystem

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

import lockstep_torch_jax as ls  # noqa: E402

SPEC = SyntheticCameraSpec(fx=120.0, fy=120.0, cx=119.5, cy=89.5, width=240, height=180)
BASELINE = 0.12
FXB = SPEC.fx * BASELINE
HE = np.array([2.0, 1.5, 2.0])
# ZNCC of 7x7 patches summed in other orders: every gate decision agrees,
# and so does the best disparity except at exact ties (the room's texture
# repeats, so a patch can match at two disparities with ZNCC 1 in float64,
# and the rounding of each package picks one); elsewhere the depth
# measured <= 4.8e-7 m apart
DEPTH_TOL = 1e-5
POSE_TOL = 1e-5  # tests/test_torch_slam.py's bound on tracked poses (measured <= 2e-7)


def _pair(i: int):
    """Left/right RGB and the left cam_T_world of frame i of
    tests/test_stereo.py's stereo trajectory."""
    w_T_l = look_at(np.array((0.3 - 0.03 * i, 0.02 * i, 0.05 * i)), np.array([0.0, 0.0, 1.5]))
    w_T_r = w_T_l.copy()
    w_T_r[:3, 3] += w_T_l[:3, 0] * BASELINE
    return render_box_room(SPEC, w_T_l, HE)[0], render_box_room(SPEC, w_T_r, HE)[0], np.linalg.inv(w_T_l)


def _zncc64(gl, gr, u: int, v: int, d: int, half: int = 3) -> float:
    """ZNCC of the left patch at (u, v) and the right one at (u - d, v),
    in float64 (the border clipping of `_gather_patches`)."""
    H, W = gl.shape
    ys = np.clip(v + np.arange(-half, half + 1), 0, H - 1)
    a = gl[np.ix_(ys, np.clip(u + np.arange(-half, half + 1), 0, W - 1))].astype(np.float64).ravel()
    b = gr[np.ix_(ys, np.clip(u - d + np.arange(-half, half + 1), 0, W - 1))].astype(np.float64).ravel()
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-9))


def test_stereo_keypoint_depth_matches_jax():
    """A grid of probes (textured and flat, near the borders, at
    subpixel positions, some invalid): the same accepted set, depth
    within DEPTH_TOL, or a disparity tie (both packages' disparities
    score the same in float64)."""
    rgb_l, rgb_r, _ = _pair(0)
    gl = np.asarray(rgb_l, np.float32).mean(-1)
    gr = np.asarray(rgb_r, np.float32).mean(-1)
    rng = np.random.default_rng(0)
    us, vs = np.meshgrid(np.arange(0, 240, 6), np.arange(0, 180, 6))
    uv = np.stack([us.ravel(), vs.ravel()], -1).astype(np.float32)
    uv += rng.uniform(-0.5, 0.5, uv.shape).astype(np.float32)
    valid = rng.random(len(uv)) < 0.9
    kw = dict(focal_x_baseline=FXB, max_disparity=48)
    with jax.disable_jit():
        jd, jok = jst.stereo_keypoint_depth(jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(uv), jnp.asarray(valid), **kw)
    td, tok = tst.stereo_keypoint_depth(torch.from_numpy(gl), torch.from_numpy(gr), torch.from_numpy(uv),
                                        torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    td, jd = td.numpy(), np.asarray(jd)
    tie = np.abs(td - jd) > DEPTH_TOL
    for k in np.nonzero(tie)[0]:
        u, v = np.round(uv[k]).astype(int)
        zj, zt = (_zncc64(gl, gr, u, v, int(np.round(FXB / x))) for x in (jd[k], td[k]))
        assert abs(zj - zt) < 1e-6, (k, uv[k], jd[k], td[k], zj, zt)
    assert tie.sum() < 0.25 * tok.sum()
    assert 30 < int(tok.sum()) < 0.5 * len(uv)  # edges match, flat cells and borders are gated out


def test_sparse_depth_image_matches_jax():
    """Rounding, clipping at the borders, invalid rows dropped, and two
    keypoints on one pixel (the later one wins, as XLA's CPU scatter)."""
    rng = np.random.default_rng(1)
    uv = rng.uniform(-3, 45, (80, 2)).astype(np.float32)
    uv[10:14] = uv[3]  # repeated pixel
    d = rng.uniform(0.5, 5.0, 80).astype(np.float32)
    ok = rng.random(80) < 0.8
    ok[10:14] = True
    with jax.disable_jit():
        j = jst.sparse_depth_image(jnp.asarray(uv), jnp.asarray(d), jnp.asarray(ok), 30, 40)
    t = tst.sparse_depth_image(torch.from_numpy(uv), torch.from_numpy(d), torch.from_numpy(ok), 30, 40)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(t[int(np.round(uv[3, 1])), int(np.round(uv[3, 0]))]) == d[13]


SLAM_KW = dict(ba_window=4, ba_max_points=1024, ba_iterations=3, max_disparity=48)
FEAT_KW, TRACK_KW = dict(max_num_keypoints=300, num_levels=2), dict(min_inliers=12, match_radius=30.0)


def _systems(c, fxb, **track_kw):
    """(JAX, port) SlamSystems of camera `c` with the file's configuration."""
    tkw = {**TRACK_KW, **track_kw}
    js = JaxSlamSystem(JaxCamera.create(c.fx, c.fy, c.cx, c.cy, c.width, c.height), fcfg=JaxFeatureConfig(**FEAT_KW),
                       tcfg=JaxTrackingConfig(**tkw), focal_x_baseline=fxb, **SLAM_KW)
    ts = SlamSystem(PinholeCamera.create(c.fx, c.fy, c.cx, c.cy, c.width, c.height), fcfg=FeatureConfig(**FEAT_KW),
                    tcfg=TrackingConfig(**tkw), focal_x_baseline=fxb, device="cpu", **SLAM_KW)
    return js, ts


def test_stereo_frames_match_jax():
    """3 stereo frames through both SlamSystems (tests/test_stereo.py's
    configuration, 300 keypoints on 2 levels): the same tracked flags, match and inlier counts and
    keyframe decisions, poses within POSE_TOL and near the ground
    truth."""
    js, ts = _systems(SPEC, FXB)
    for i in range(3):
        rgb_l, rgb_r, cTw = _pair(i)
        jh = JaxSE3.from_matrix(jnp.asarray(cTw, jnp.float32)) if i == 0 else None
        th = SE3.from_matrix(torch.as_tensor(cTw, dtype=torch.float32)) if i == 0 else None
        with jax.disable_jit():
            ji = js.feed_stereo_frame(rgb_l, rgb_r, float(i), pose_hint=jh)
        ti = ts.feed_stereo_frame(rgb_l, rgb_r, float(i), pose_hint=th)
        for name in ("tracked", "num_matches", "num_inliers", "inserted_keyframe", "relocalized"):
            assert getattr(ti, name) == getattr(ji, name), (i, name)
        np.testing.assert_allclose(ti.pose.R.numpy(), np.asarray(ji.pose.R), atol=POSE_TOL)
        np.testing.assert_allclose(ti.pose.t.numpy(), np.asarray(ji.pose.t), atol=POSE_TOL)
        assert ti.tracked and np.linalg.norm(ti.pose.t.numpy() - cTw[:3, 3]) < 0.1
        if i > 0:
            assert ti.num_inliers >= 12
    assert int(ts.state.track.lms.valid.sum()) == int(js.state.track.lms.valid.sum()) > 50


ROBOT = SyntheticCameraSpec(fx=175.0, fy=175.0, cx=167.5, cy=93.5, width=336, height=188)
ROOM = np.array([3.0, 1.5, 2.5])
PAIRS = 6


def _robot_pair(i: int):
    """Left / right RGB of witness pair i: on an arc of radius 1 m about
    the clutter room's middle, 0.3 deg a pair, looking outward."""
    a = np.radians(0.3 * i)
    eye = np.array([np.cos(a), 0.1, np.sin(a)])
    w_T_l = look_at(eye, eye + np.array([np.cos(a + 0.4), 0.05, np.sin(a + 0.4)]))
    w_T_r = w_T_l.copy()
    w_T_r[:3, 3] += w_T_l[:3, 0] * BASELINE
    return (render_box_room(ROBOT, w_T_l, ROOM, clutter=12)[0],
            render_box_room(ROBOT, w_T_r, ROOM, clutter=12)[0])


# The facade gates a stereo camera's keypoint depths through
# tcfg.max_depth (40 baselines, 4.8 m at this baseline, beyond this room);
# the gated witness sets it at the room's median depth, so that about half
# the keypoints' depths are dropped.
GATE = 1.9


def _step_witness(**track_kw):
    """(port feedback, JAX feedback, what parts, port landmarks) after
    every pair."""
    js, ts = _systems(ROBOT, ROBOT.fx * BASELINE, **track_kw)
    out = []
    for i in range(PAIRS):
        left, right = _robot_pair(i)
        with jax.disable_jit():
            ji = ls.jax_info(js.feed_stereo_frame(left, right, i / 60.0))
            jflat = ls.flat_jax(js.state)
        ti = ls.port_info(ts.feed_stereo_frame(left, right, i / 60.0))
        out.append((ti, ji, ls.compare(ls.flat_port(ts.state), ti, jflat, ji), int(ts.state.track.lms.valid.sum())))
    return out


@pytest.fixture(scope="module")
def witness():
    return _step_witness()


@pytest.fixture(scope="module")
def gated_witness():
    return _step_witness(max_depth=GATE)


@pytest.mark.parametrize("pair", range(PAIRS))
def test_stereo_witness_step_matches_jax(witness, pair):
    ti, ji, bad, _ = witness[pair]
    assert not bad, bad
    assert ti["tracked"] == 1 and (pair == 0 or ti["num_inliers"] >= 50)


@pytest.mark.parametrize("pair", range(PAIRS))
def test_gated_stereo_witness_step_matches_jax(witness, gated_witness, pair):
    """The witness with keypoint depths gated inside the room: the two
    packages agree as ungated, and the gate makes fewer landmarks."""
    ti, ji, bad, lms = gated_witness[pair]
    assert not bad, bad
    assert ti["tracked"] == 1 and lms < witness[pair][3]
