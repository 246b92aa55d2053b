"""Loop closing of the PyTorch port (ra_slam_tpu_torch/slam/system.py's
close branch: loop edge, pose-graph optimisation, landmark correction,
global BA; and `refine_map`) against the JAX package on the CPU.

The run is an aggressive loop configuration in the manner of
tests/test_pose_graph.py's system test: the 160x120 synthetic orbit, a
keyframe every other frame, a loop check at every keyframe with a
retrieval gap of 2 keyframes and no consistency streak, so that both
packages close a loop at frame 4 (keyframe 2 onto keyframe 0). Its JAX
side runs jitted, as the JAX package runs it: op by op (see
tests/torch_parity.py) the five frames take ~100 s on a CPU, and every
decision of this run agrees either way. The module-level JAX calls run
op by op, except the close and global-BA steps, which are jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.core.config import FeatureConfig as JaxFeatureConfig
from ra_slam_tpu.core.config import TrackingConfig as JaxTrackingConfig
from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.slam import loop_closure as jlc
from ra_slam_tpu.slam import system as jsys
from ra_slam_tpu.slam.system import SlamSystem as JaxSlamSystem
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import FeatureConfig, TrackingConfig
from ra_slam_tpu_torch.core.se3 import SE3, exp_se3
from ra_slam_tpu_torch.parallel import LocalMesh
from ra_slam_tpu_torch.slam import system as tsys
from ra_slam_tpu_torch.slam.loop_closure import LoopCandidate
from ra_slam_tpu_torch.slam.system import SlamSystem
from ra_slam_tpu_torch.utils.convert import slam_state_from_numpy, slam_state_to_numpy, tree_from_numpy

W, H, N_FRAMES, CLOSE_AT = 160, 120, 5, 4
FEAT_KW = dict(max_num_keypoints=200, num_levels=2)
TRACK_KW = dict(min_inliers=12, match_radius=15.0, keyframe_min_interval=1, keyframe_translation=0.02,
                keyframe_rotation=0.02, max_keyframes=16, max_map_points=1024)
SLAM_KW = dict(ba_window=4, ba_max_points=512, ba_iterations=3, loop_every_kf=1, loop_min_gap=2,
               loop_min_inliers=10, loop_consistency=1, pgo_iterations=3, gba_window=8)
# float32 tracking, PGO (a [96, 96] Cholesky under a 1e6 gauge prior) and
# global BA from identical discrete inputs, summed in other orders (and
# XLA's jitted fused multiply-adds): measured <= 1.8e-6 on poses and
# <= 9.6e-7 on landmark positions
POSE_TOL = 2e-5
POINT_TOL = 5e-5
RMSE_TOL = 1e-4  # px (and m of PGO shift), of values ~0.5 (measured <= 1.5e-6 apart)


def _dataset():
    spec = SyntheticCameraSpec(fx=W / 2, fy=W / 2, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    return SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _port_system(ds) -> SlamSystem:
    c = ds.camera
    cam = PinholeCamera.create(float(c.fx), float(c.fy), float(c.cx), float(c.cy), c.width, c.height)
    return SlamSystem(cam, fcfg=FeatureConfig(**FEAT_KW), tcfg=TrackingConfig(**TRACK_KW), device="cpu", **SLAM_KW)


@functools.lru_cache()
def _run():
    """Both systems over N_FRAMES: per-frame feedback, both systems, and
    the JAX state (numpy) after every frame."""
    ds = _dataset()
    js = JaxSlamSystem(ds.camera, fcfg=JaxFeatureConfig(**FEAT_KW), tcfg=JaxTrackingConfig(**TRACK_KW), **SLAM_KW)
    ts = _port_system(ds)
    infos, states = [], []
    for i in range(N_FRAMES):
        fr = ds.frame(i)
        ji = js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i)
        ti = ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i)
        infos.append((ji, ti))
        states.append(_np_tree(js.state))
    return ds, js, ts, infos, states


def _assert_states(t, j):
    """Port state vs JAX state (numpy): counters and edges' integer
    fields exact, poses and landmarks within the bounds."""
    for name in ("n_edges", "n_loops", "n_relocs", "n_frames", "loop_prev_cand", "loop_streak"):
        assert int(getattr(t, name)) == int(getattr(j, name)), name
    for name in ("i", "j", "weight"):
        np.testing.assert_array_equal(getattr(t.edges, name).numpy(), np.asarray(getattr(j.edges, name)), err_msg=name)
    np.testing.assert_allclose(t.edges.t.numpy(), np.asarray(j.edges.t), atol=POSE_TOL)
    for name in ("R", "t"):
        np.testing.assert_allclose(getattr(t.kfs, name).numpy(), np.asarray(getattr(j.kfs, name)), atol=POSE_TOL)
        np.testing.assert_allclose(getattr(t.track.pose, name).numpy(), np.asarray(getattr(j.track.pose, name)),
                                   atol=POSE_TOL)
    for name in ("valid", "anchor", "n_obs"):
        np.testing.assert_array_equal(getattr(t.track.lms, name).numpy(), np.asarray(getattr(j.track.lms, name)))
    np.testing.assert_allclose(t.track.lms.pos.numpy(), np.asarray(j.track.lms.pos), atol=POINT_TOL)
    np.testing.assert_array_equal(t.kfs.obs_w.numpy(), np.asarray(j.kfs.obs_w))


def test_loop_closing_run_matches_jax():
    """Both packages close the loop at frame 4, and only there: every
    frame's decisions and counts equal, the closure's PGO shift and GBA
    rmse within the bounds, the final states alike."""
    _, js, ts, infos, states = _run()
    for i, (ji, ti) in enumerate(infos):
        for name in ("tracked", "num_matches", "num_inliers", "inserted_keyframe", "relocalized",
                     "loop_closed", "loop_cand", "loop_inliers"):
            assert getattr(ti, name) == getattr(ji, name), (i, name)
        np.testing.assert_allclose(ti.pose.t.numpy(), np.asarray(ji.pose.t), atol=POSE_TOL)
        for name in ("ba_rmse", "pgo_shift", "loop_rmse"):  # JAX's FrameInfo names no pgo_shift
            np.testing.assert_allclose(getattr(ti, name), float(getattr(ji._pull(), name)), atol=RMSE_TOL,
                                       err_msg=str((i, name)))
    assert [ti.loop_closed for _, ti in infos] == [i == CLOSE_AT for i in range(N_FRAMES)]
    assert ts.num_loop_closures == js.num_loop_closures == 1
    assert np.isfinite(infos[CLOSE_AT][1].ba_rmse) and infos[CLOSE_AT][1].pgo_shift > 0
    _assert_states(ts.state, states[-1])
    for (_, a), (_, b) in zip(js.trajectory(), ts.trajectory()):
        np.testing.assert_allclose(b, a, atol=POSE_TOL)


def test_close_branch_from_carried_state_matches_jax():
    """The JAX state after frame 3 goes to the port; the port steps frame
    4, which closes the loop, and its state equals JAX's after frame 4."""
    ds, _, _, infos, states = _run()
    ts = _port_system(ds)
    ts.state = slam_state_from_numpy(states[CLOSE_AT - 1], "cpu")
    ts._frames = [(i, ds.frame(i).timestamp) for i in range(CLOSE_AT)]
    fr = ds.frame(CLOSE_AT)
    info = ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=CLOSE_AT)
    assert info.loop_closed and info.inserted_keyframe and info.tracked
    _assert_states(ts.state, states[CLOSE_AT])
    back = slam_state_to_numpy(ts.state)
    assert int(back.n_loops) == 1 and back.track.lms.desc.dtype == np.uint32


def _perturbed(state_np, slot: int):
    """The JAX state (numpy) with keyframe `slot`'s pose moved by a fixed
    twist, so the odometry and loop edges disagree with it."""
    xi = np.asarray([0.01, -0.02, 0.015, 0.04, -0.03, 0.02], np.float32)
    dT = exp_se3(torch.from_numpy(xi))
    R, t = np.array(state_np.kfs.R), np.array(state_np.kfs.t)
    T = dT @ SE3(torch.from_numpy(R[slot]), torch.from_numpy(t[slot]))
    R[slot], t[slot] = T.R.numpy(), T.t.numpy()
    return state_np._replace(kfs=state_np.kfs._replace(R=R, t=t))


def test_loop_close_and_gba_steps_match_jax():
    """Module level, from the JAX state after frame 4 with the newest
    keyframe moved off: JAX's loop verification of keyframe 2 against
    keyframe 0 is given to both `_loop_close_step`s (loop edge, PGO,
    landmark correction, the tracker re-anchored), then both
    `_gba_step`s run."""
    ds, js, ts, _, states = _run()
    s4 = states[CLOSE_AT]
    q = int(s4.track.kf_counter) - 1
    assert q == 2
    jst = jax.tree.map(jnp.asarray, _perturbed(s4, q))
    jtc = JaxTrackingConfig(**TRACK_KW)
    with jax.disable_jit():
        loop = jlc.detect_loop(jst.kfs, jst.track.lms, jnp.int32(q), jst.track.kf_counter, cam=ds.camera, tcfg=jtc,
                               min_gap=2, min_inliers=10)
    assert bool(loop.accepted) and int(loop.cand) == 0
    p = js.params
    close = jax.jit(lambda s, lp: jsys._loop_close_step(s, lp, jnp.int32(q), p))
    gba = jax.jit(lambda s: jsys._gba_step(s, ds.camera, p))
    j1, j_shift, j_pgo = close(jst, loop)
    j2, j_rmse = gba(j1)

    tst = slam_state_from_numpy(_perturbed(s4, q), "cpu")
    tloop = tree_from_numpy(LoopCandidate, _np_tree(loop), "cpu")
    t1, t_shift, t_pgo = tsys._loop_close_step(tst, tloop, torch.tensor(q, dtype=torch.int32), ts.params)
    _assert_states(t1, _np_tree(j1))
    np.testing.assert_allclose(float(t_shift), float(j_shift), atol=POSE_TOL)
    assert float(t_shift) > 1e-3  # the loop edge moved the perturbed keyframe
    for name in ("rmse_before", "rmse_after"):
        np.testing.assert_allclose(float(getattr(t_pgo, name)), float(getattr(j_pgo, name)), atol=RMSE_TOL)
    t2, t_rmse = tsys._gba_step(t1, ts.cam, ts.params)
    _assert_states(t2, _np_tree(j2))
    np.testing.assert_allclose(float(t_rmse), float(j_rmse), atol=RMSE_TOL)


def test_refine_map_matches_jax():
    """`refine_map` (sliding-window sweeps over the whole keyframe
    database) from the JAX state after the run, in both packages."""
    ds, js, _, _, states = _run()
    kw = dict(window=2, iterations=3, sweeps=2)
    jsys_ = JaxSlamSystem(ds.camera, fcfg=JaxFeatureConfig(**FEAT_KW), tcfg=JaxTrackingConfig(**TRACK_KW), **SLAM_KW)
    jsys_.state = jax.tree.map(jnp.asarray, states[-1])
    with jax.disable_jit():
        jr = jsys_.refine_map(**kw)
    ts = _port_system(ds)
    ts.state = slam_state_from_numpy(states[-1], "cpu")
    tr = ts.refine_map(**kw)
    assert tr["windows"] == jr["windows"] == 4
    for name in ("rmse_before", "rmse_after"):
        np.testing.assert_allclose(tr[name], jr[name], atol=RMSE_TOL)
    assert tr["rmse_after"] <= tr["rmse_before"]
    _assert_states(ts.state, _np_tree(jsys_.state))
    # over a one-shard mesh the distributed solver runs the same
    # operations as solve_window: the same result bit for bit
    tm = _port_system(ds)
    tm.state = slam_state_from_numpy(states[-1], "cpu")
    assert tm.refine_map(mesh=LocalMesh(1, "cpu", axis="ba"), **kw) == tr
    assert torch.equal(tm.state.kfs.t, ts.state.kfs.t) and torch.equal(tm.state.track.lms.pos, ts.state.track.lms.pos)
