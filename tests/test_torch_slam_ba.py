"""Windowed bundle adjustment inside the SLAM system of the PyTorch port
(`ba_every_kf`, with the observation repair `reassoc_mode`) and
`refresh_observations` against the JAX package on the CPU.

The run is tests/test_torch_slam.py's: the first 8 frames of the 320x240
synthetic orbit, now with a windowed BA at every keyframe, the stored
rows repaired first by dropping (mode 1) or re-measuring (mode 2) the
ones the landmark sheet disagrees with. Its JAX side runs jitted, as the
JAX package runs it: op by op (see tests/torch_parity.py) one run takes
~75 s on a CPU, and every decision of this run agrees either way. The module
test runs the JAX side op by op.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.core.config import FeatureConfig as JaxFeatureConfig
from ra_slam_tpu.core.config import TrackingConfig as JaxTrackingConfig
from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu.slam import keyframes as jkf
from ra_slam_tpu.slam.system import SlamSystem as JaxSlamSystem
from ra_slam_tpu_torch.core.config import FeatureConfig, TrackingConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.slam import keyframes as tkf
from ra_slam_tpu_torch.slam.keyframes import Keyframes
from ra_slam_tpu_torch.slam.landmarks import Landmarks
from ra_slam_tpu_torch.slam.system import SlamSystem
from ra_slam_tpu_torch.utils.convert import tree_from_numpy

import test_torch_slam as ts_

N_FRAMES = 8
# float32 tracking and window solves from identical discrete inputs,
# summed in other orders (and XLA's jitted fused multiply-adds): measured
# <= 1.4e-6 on poses, <= 4.8e-7 on landmarks, <= 1.6e-5 px on the stored
# (re-measured) keyframe pixels
POSE_TOL = 1e-5
POINT_TOL = 2e-5
UV_TOL = 1e-3
RMSE_TOL = 1e-4  # px, of a window rmse of ~0.4 px (measured <= 2.4e-7 apart)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


@functools.lru_cache()
def _run(mode: int):
    """Both systems over N_FRAMES with BA at every keyframe and
    `reassoc_mode=mode`: per-frame feedback and both systems."""
    ds = ts_._dataset()
    jcam, tcam = ts_._cams(ds)
    kw = dict(ts_.SLAM_KW, ba_every_kf=1, reassoc_mode=mode)
    js = JaxSlamSystem(jcam, fcfg=JaxFeatureConfig(**ts_.FEAT_KW), tcfg=JaxTrackingConfig(**ts_.TRACK_KW), **kw)
    ts = SlamSystem(tcam, fcfg=FeatureConfig(**ts_.FEAT_KW), tcfg=TrackingConfig(**ts_.TRACK_KW), device="cpu", **kw)
    infos = []
    for i in range(N_FRAMES):
        fr = ds.frame(i)
        jh = JaxSE3.from_matrix(jnp.asarray(fr.cam_T_world)) if i == 0 else None
        th = SE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
        ji = js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=jh)
        ti = ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=th)
        infos.append((ji, ti))
    return js, ts, infos


@pytest.mark.parametrize("mode", [1, 2], ids=["drop", "refresh"])
def test_windowed_ba_run_matches_jax(mode):
    """Every frame's decisions and counts equal, the BA rmse, dropped
    points and shift of each keyframe within the bounds, and the
    keyframe and landmark databases alike at the end."""
    js, ts, infos = _run(mode)
    n_ba = 0
    for i, (ji, ti) in enumerate(infos):
        for name in ("tracked", "num_matches", "num_inliers", "inserted_keyframe", "relocalized", "loop_closed"):
            assert getattr(ti, name) == getattr(ji, name), (i, name)
        np.testing.assert_allclose(ti.pose.R.numpy(), np.asarray(ji.pose.R), atol=POSE_TOL)
        np.testing.assert_allclose(ti.pose.t.numpy(), np.asarray(ji.pose.t), atol=POSE_TOL)
        jd = ji._pull()  # JAX's FrameInfo names no ba_dropped / ba_shift
        np.testing.assert_allclose(ti.ba_rmse, ji.ba_rmse, atol=RMSE_TOL, err_msg=str(i))
        np.testing.assert_allclose(ti.ba_shift, float(jd.ba_shift), atol=POSE_TOL, err_msg=str(i))
        assert ti.ba_dropped == int(jd.ba_dropped)
        n_ba += np.isfinite(ti.ba_rmse)
    assert n_ba == sum(ti.inserted_keyframe for _, ti in infos[1:]) >= 1
    t, j = ts.state, js.state
    assert int(t.track.kf_counter) == int(j.track.kf_counter) >= 2
    np.testing.assert_allclose(t.kfs.R.numpy(), np.asarray(j.kfs.R), atol=POSE_TOL)
    np.testing.assert_allclose(t.kfs.t.numpy(), np.asarray(j.kfs.t), atol=POSE_TOL)
    np.testing.assert_array_equal(t.kfs.obs_w.numpy(), np.asarray(j.kfs.obs_w))
    np.testing.assert_allclose(t.kfs.obs_uv.numpy(), np.asarray(j.kfs.obs_uv), atol=UV_TOL)
    np.testing.assert_array_equal(t.track.lms.valid.numpy(), np.asarray(j.track.lms.valid))
    np.testing.assert_allclose(t.track.lms.pos.numpy(), np.asarray(j.track.lms.pos), atol=POINT_TOL)


@pytest.mark.parametrize("mode", [1, 2], ids=["drop", "refresh"])
def test_refresh_observations_matches_jax(mode):
    """From the run's final state with a quarter of the landmarks moved
    0.1 m (and one behind every camera): the same rows found stale, the
    same repair."""
    js, ts, _ = _run(1)
    kfs, lms = _np_tree(js.state.kfs), _np_tree(js.state.track.lms)
    rng = np.random.default_rng(mode)
    pos = np.array(lms.pos)
    moved = rng.random(len(pos)) < 0.25
    pos[moved] += rng.normal(0, 0.1, (int(moved.sum()), 3)).astype(np.float32)
    seen = np.asarray(kfs.obs_lm)[0][np.asarray(kfs.obs_w)[0] > 0]
    pos[seen[0]] = [0.0, 0.0, -50.0]  # behind the cameras
    lms = lms._replace(pos=pos)
    with jax.disable_jit():
        jk, jn = jkf.refresh_observations(jax.tree.map(jnp.asarray, kfs), jax.tree.map(jnp.asarray, lms),
                                          js.cam, 8.0, mode)
    tk, tn = tkf.refresh_observations(tree_from_numpy(Keyframes, kfs, "cpu"), tree_from_numpy(Landmarks, lms, "cpu"),
                                      ts.cam, 8.0, mode)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tk.obs_w.numpy(), np.asarray(jk.obs_w))
    # the same projection, op by op on both sides: measured equal
    np.testing.assert_allclose(tk.obs_uv.numpy(), np.asarray(jk.obs_uv), atol=1e-4)
    np.testing.assert_allclose(tk.obs_z.numpy(), np.asarray(jk.obs_z), atol=1e-6)
    if mode == 1:
        assert (tk.obs_w.numpy() == 0).sum() == (np.asarray(kfs.obs_w) == 0).sum() + int(tn)
