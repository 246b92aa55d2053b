"""RGB-D tracking of the PyTorch port (ra_slam_tpu_torch/slam/, core/se3,
utils/pose_buffer, eval/) against the JAX package on the CPU.

The slice as a whole: both `SlamSystem`s, loop closing off, track the
first 8 frames of the 320x240 synthetic orbit (300 keypoints on 2
levels, 2048 landmarks, 32 keyframes). The JAX side runs op by op (see
tests/torch_parity.py). Its states after frames 3 and 7 also feed the
module-level tests: tracking, keyframe insertion, relocalization and
loop verification run in both packages from the same state. Loop
closing, BA in the frame step and stereo frames are held against JAX in
tests/test_torch_slam_loop.py, tests/test_torch_slam_ba.py and
tests/test_torch_stereo.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.core import se3 as jse3
from ra_slam_tpu.core.camera import PinholeCamera as JaxCamera
from ra_slam_tpu.core.config import FeatureConfig as JaxFeatureConfig
from ra_slam_tpu.core.config import TrackingConfig as JaxTrackingConfig
from ra_slam_tpu.eval import ate as jate
from ra_slam_tpu.features import orb as jorb
from ra_slam_tpu.features.pyramid import rgb_to_gray as jax_gray
from ra_slam_tpu.io.folder import load_trajectory as jax_load_trajectory
from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.slam import keyframes as jkf
from ra_slam_tpu.slam import landmarks as jlm
from ra_slam_tpu.slam import loop_closure as jlc
from ra_slam_tpu.slam import pnp as jpnp
from ra_slam_tpu.slam import tracker as jtr
from ra_slam_tpu.slam.system import SlamSystem as JaxSlamSystem
from ra_slam_tpu.utils.pose_buffer import PoseBuffer as JaxPoseBuffer
from ra_slam_tpu_torch.core import se3 as tse3
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import FeatureConfig, TrackingConfig
from ra_slam_tpu_torch.eval import ate as tate
from ra_slam_tpu_torch.eval import trajectory_bench
from ra_slam_tpu_torch.features.orb import Keypoints
from ra_slam_tpu_torch.io import folder as tfolder
from ra_slam_tpu_torch.slam import keyframes as tkf
from ra_slam_tpu_torch.slam import landmarks as tlm
from ra_slam_tpu_torch.slam import loop_closure as tlc
from ra_slam_tpu_torch.slam import pnp as tpnp
from ra_slam_tpu_torch.slam import tracker as ttr
from ra_slam_tpu_torch.slam.system import SlamSystem
from ra_slam_tpu_torch.utils.convert import slam_state_from_numpy, slam_state_to_numpy
from ra_slam_tpu_torch.utils.pose_buffer import PoseBuffer

W, H, N_FRAMES = 320, 240, 8
FEAT_KW = dict(max_num_keypoints=300, num_levels=2)
TRACK_KW = dict(min_inliers=15, match_radius=30.0, max_map_points=2048, max_keyframes=32)
SLAM_KW = dict(loop_every_kf=1, loop_min_inliers=20, loop_min_gap=10**6)
# poses: float32 GN over ~50-100 correspondences from identical
# discrete inputs; the two packages sum in other orders (einsum, 6x6
# and 3x3 solves), measured <= 4e-7 over the 8 frames
POSE_TOL = 1e-5
GEOM_TOL = 1e-6  # se3 maps on unit-scale inputs


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _jnp_tree(x):
    return jax.tree.map(jnp.asarray, x)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


def _dataset():
    spec = SyntheticCameraSpec(fx=W / 2, fy=W / 2, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    return SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, depth_noise=0.005, seed=0)


def _cams(ds):
    c = ds.camera
    return c, PinholeCamera.create(float(c.fx), float(c.fy), float(c.cx), float(c.cy), c.width, c.height)


@functools.lru_cache()
def _run():
    """Both systems over N_FRAMES: per-frame feedback, the port's final
    system, and the JAX state (numpy) after every frame."""
    ds = _dataset()
    jcam, tcam = _cams(ds)
    js = JaxSlamSystem(jcam, fcfg=JaxFeatureConfig(**FEAT_KW), tcfg=JaxTrackingConfig(**TRACK_KW), **SLAM_KW)
    ts = SlamSystem(tcam, fcfg=FeatureConfig(**FEAT_KW), tcfg=TrackingConfig(**TRACK_KW), device="cpu", **SLAM_KW)
    infos, states = [], []
    with jax.disable_jit():
        for i in range(N_FRAMES):
            fr = ds.frame(i)
            jh = jse3.SE3.from_matrix(jnp.asarray(fr.cam_T_world)) if i == 0 else None
            th = tse3.SE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
            ji = js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=jh)
            ti = ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=th)
            infos.append((ji, ti))
            states.append(_np_tree(js.state))
    return ds, js, ts, infos, states


@functools.lru_cache()
def _keypoints(i: int):
    """JAX ORB of frame i (op by op), as JAX and as port Keypoints."""
    fr = _dataset().frame(i)
    with jax.disable_jit():
        kj = jorb.detect_and_describe(jax_gray(jnp.asarray(fr.rgb, jnp.float32)), JaxFeatureConfig(**FEAT_KW))
    kn = _np_tree(kj)
    return kj, Keypoints(*(_t(getattr(kn, f.name)) for f in dataclasses.fields(Keypoints))), fr


def _assert_pose(tpose, jpose, tol=POSE_TOL):
    np.testing.assert_allclose(tpose.R.numpy(), np.asarray(jpose.R), atol=tol)
    np.testing.assert_allclose(tpose.t.numpy(), np.asarray(jpose.t), atol=tol)


def _assert_landmarks(t, j):
    """Slot by slot: integer fields and flags exact, positions within
    POSE_TOL (they unproject through the tracked pose)."""
    for name in ("valid", "n_obs", "last_seen", "anchor"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(t.desc.numpy().view(np.uint32), np.asarray(j.desc))
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), atol=POSE_TOL)


def test_slam_system_matches_jax():
    """The slice as a whole: every frame's tracked flag, match and inlier
    counts and keyframe decision equal JAX's, poses within POSE_TOL;
    keyframe and landmark counts equal at the end."""
    ds, js, ts, infos, _ = _run()
    for i, (ji, ti) in enumerate(infos):
        for name in ("tracked", "num_matches", "num_inliers", "inserted_keyframe", "relocalized", "loop_closed"):
            assert getattr(ti, name) == getattr(ji, name), (i, name)
        _assert_pose(ti.pose, ji.pose)
    assert all(ti.tracked for _, ti in infos)
    assert int(ts.state.track.kf_counter) == int(js.state.track.kf_counter) >= 2
    assert int(tlm.num_valid(ts.state.track.lms)) == int(jlm.num_valid(js.state.track.lms)) > 50
    _assert_landmarks(ts.state.track.lms, js.state.track.lms)
    tj, tt = js.trajectory(), ts.trajectory()
    assert [f for f, _ in tt] == [f for f, _ in tj] == list(range(N_FRAMES))
    for (_, a), (_, b) in zip(tj, tt):
        np.testing.assert_allclose(b, a, atol=POSE_TOL)
    assert [f for f, _ in ts.keyframe_trajectory()] == [f for f, _ in js.keyframe_trajectory()]
    assert ts.num_loop_closures == ts.num_relocalizations == 0 and not ts.lost
    q = ts.query_pose(ds.frame(5).timestamp)
    _assert_pose(q, js.query_pose(ds.frame(5).timestamp))


def test_state_carried_across_steps_like_jax():
    """The JAX state after frame 3 goes to the port through
    slam_state_from_numpy; frame 4 (a keyframe) is stepped in the port
    and the state compared with JAX's after frame 4."""
    ds, _, _, infos, states = _run()
    assert infos[4][0].inserted_keyframe
    jcam, tcam = _cams(ds)
    ts = SlamSystem(tcam, fcfg=FeatureConfig(**FEAT_KW), tcfg=TrackingConfig(**TRACK_KW), device="cpu", **SLAM_KW)
    ts.state = slam_state_from_numpy(states[3], "cpu")
    ts._frames = [(i, ds.frame(i).timestamp) for i in range(4)]
    fr = ds.frame(4)
    info = ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=4)
    assert info.inserted_keyframe and info.tracked
    t, j = ts.state, states[4]
    _assert_landmarks(t.track.lms, j.track.lms)
    _assert_pose(t.track.pose, j.track.pose)
    for name in ("kf_counter", "frames_since_kf", "initialized", "lost", "bad_streak"):
        assert int(getattr(t.track, name)) == int(getattr(j.track, name)), name
    for name in ("valid", "frame_id", "obs_lm", "obs_w", "embed", "desc"):
        np.testing.assert_array_equal(getattr(t.kfs, name).numpy().view(np.asarray(getattr(j.kfs, name)).dtype),
                                      np.asarray(getattr(j.kfs, name)), err_msg=name)
    for name in ("R", "t", "obs_uv", "obs_z"):
        np.testing.assert_allclose(getattr(t.kfs, name).numpy(), np.asarray(getattr(j.kfs, name)), atol=POSE_TOL)
    for name in ("i", "j", "weight"):
        np.testing.assert_array_equal(getattr(t.edges, name).numpy(), np.asarray(getattr(j.edges, name)))
    np.testing.assert_allclose(t.edges.t.numpy(), np.asarray(j.edges.t), atol=POSE_TOL)
    for name in ("n_edges", "n_frames", "loop_prev_cand", "loop_streak", "n_relocs"):
        assert int(getattr(t, name)) == int(getattr(j, name)), name
    back = slam_state_to_numpy(t)
    assert back.track.lms.desc.dtype == np.uint32 and back.kfs.R.shape == np.asarray(j.kfs.R).shape


def test_track_frame_and_keyframe_insertion_match_jax():
    """From the JAX state after frame 3 and JAX's keypoints of frame 4:
    matches, inliers and the keyframe decision exact, the pose within
    POSE_TOL; then the keyframe's landmarks slot by slot."""
    ds, _, _, _, states = _run()
    jcam, tcam = _cams(ds)
    kj, kt, fr = _keypoints(4)
    jtc, ttc = JaxTrackingConfig(**TRACK_KW), TrackingConfig(**TRACK_KW)
    depth = np.asarray(fr.depth, np.float32)
    with jax.disable_jit():
        jst, jres = jtr.track_frame(_jnp_tree(states[3].track), kj, jnp.asarray(depth), jcam, jtc)
        jst2, jobs, jz = jtr.insert_keyframe_landmarks(jst, kj, jnp.asarray(depth), jres.lm_idx, jcam, jtc)
    tst0 = slam_state_from_numpy(states[3], "cpu").track
    tst, tres = ttr.track_frame(tst0, kt, torch.from_numpy(depth), tcam, ttc)
    for name in ("lm_idx", "inlier", "need_keyframe", "num_matches", "num_inliers"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)), err_msg=name)
    _assert_pose(tst.pose, jst.pose)
    _assert_landmarks(tst.lms, jst.lms)
    tst2, tobs, tz = ttr.insert_keyframe_landmarks(tst, kt, torch.from_numpy(depth), tres.lm_idx, tcam, ttc)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6)
    _assert_landmarks(tst2.lms, jst2.lms)
    assert int(tst2.kf_counter) == int(jst2.kf_counter)


def test_relocalize_and_detect_loop_match_jax():
    """From the JAX state after frame 7 (two keyframes): relocalization
    of frame 7 and loop verification of keyframe 1 against keyframe 0
    (min_gap 1, so retrieval finds it) give the same candidate, inlier
    count and decision, and poses within POSE_TOL."""
    ds, _, _, _, states = _run()
    jcam, tcam = _cams(ds)
    kj, kt, _ = _keypoints(7)
    jtc, ttc = JaxTrackingConfig(**TRACK_KW), TrackingConfig(**TRACK_KW)
    jst, tst = _jnp_tree(states[7]), slam_state_from_numpy(states[7], "cpu")
    assert int(jst.track.kf_counter) == 2
    kfc = jnp.int32(2)
    with jax.disable_jit():
        jr = jlc.relocalize(jst.kfs, jst.track.lms, kj.desc, kj.valid, kj.uv, kfc, jcam, jtc)
        jl = jlc.detect_loop(jst.kfs, jst.track.lms, jnp.int32(1), kfc, jcam, jtc, min_gap=1, min_inliers=10)
    tr = tlc.relocalize(tst.kfs, tst.track.lms, kt.desc, kt.valid, kt.uv, tst.track.kf_counter, tcam, ttc)
    tl = tlc.detect_loop(tst.kfs, tst.track.lms, torch.tensor(1, dtype=torch.int32), tst.track.kf_counter,
                         tcam, ttc, min_gap=1, min_inliers=10)
    for t, j, names in ((tr, jr, ("cand", "num_inliers", "accepted")), (tl, jl, ("cand", "num_inliers", "accepted"))):
        for name in names:
            assert int(getattr(t, name)) == int(getattr(j, name)), name
    assert bool(jr.accepted) and int(jl.cand) == 0 and int(jl.num_inliers) > 10
    _assert_pose(tr.pose, jr.pose)
    _assert_pose(tl.rel_pose, jl.rel_pose)
    np.testing.assert_allclose(float(tl.score), float(jl.score), atol=1e-6)
    np.testing.assert_allclose(float(tl.rmse), float(jl.rmse), atol=1e-4)


def test_landmark_store_matches_jax_slot_by_slot():
    """Insertion into free slots with holes, observation counts with
    repeated indices, culling: every slot equal."""
    rng = np.random.default_rng(0)
    M, K = 64, 40
    base = jlm.create_landmarks(M)
    base = base._replace(
        valid=jnp.asarray(rng.random(M) < 0.6),
        n_obs=jnp.asarray(rng.integers(0, 4, M), jnp.int32),
        last_seen=jnp.asarray(rng.integers(0, 5, M), jnp.int32),
    )
    pos = rng.normal(size=(K, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    mask = rng.random(K) < 0.7
    idx = rng.integers(-1, M, K).astype(np.int32)
    idx[:6] = 7  # repeated index
    obs_mask = rng.random(K) < 0.8
    kfc = 9
    with jax.disable_jit():
        j1, jslots = jlm.add_landmarks(base, jnp.asarray(pos), jnp.asarray(desc), jnp.asarray(mask), jnp.int32(kfc))
        j2 = jlm.record_observations(j1, jnp.asarray(idx), jnp.asarray(obs_mask), jnp.int32(kfc))
        j3 = jlm.cull_landmarks(j2, jnp.int32(kfc + 5), min_obs=2, max_age=6)
    t0 = tlm.Landmarks(*(_t(getattr(base, f.name)) for f in dataclasses.fields(tlm.Landmarks)))
    kt = torch.tensor(kfc, dtype=torch.int32)
    t1, tslots = tlm.add_landmarks(t0, _t(pos), _t(desc), torch.from_numpy(mask), kt)
    t2 = tlm.record_observations(t1, _t(idx), torch.from_numpy(obs_mask), kt)
    t3 = tlm.cull_landmarks(t2, kt + 5, min_obs=2, max_age=6)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    assert (np.asarray(jslots) >= 0).sum() == min(mask.sum(), (~np.asarray(base.valid)).sum())
    for t, j in ((t1, j1), (t2, j2), (t3, j3)):
        _assert_landmarks(t, j)
    # a repeated index: the last write wins, as XLA's CPU scatter orders it
    x = tlm.scatter_rows(torch.zeros(4), torch.tensor([1, 1, 2, 1]), torch.tensor([5.0, 7.0, 3.0, 9.0]),
                         torch.tensor([True, True, True, True]))
    np.testing.assert_array_equal(x.numpy(), [0.0, 9.0, 3.0, 0.0])


def test_insert_keyframe_matches_jax():
    rng = np.random.default_rng(1)
    F = 50
    kfs_j = jkf.create_keyframes(6, F)
    kfs_t = tkf.create_keyframes(6, F, "cpu")
    R = np.asarray(jse3.exp_so3(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    tv = np.array([0.5, -1.0, 2.0], np.float32)
    obs_lm = rng.integers(-1, 100, F).astype(np.int32)
    uv = rng.uniform(0, 300, (F, 2)).astype(np.float32)
    w = (rng.random(F) < 0.7).astype(np.float32)
    desc = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    z = rng.uniform(0, 3, F).astype(np.float32)
    with jax.disable_jit():
        j = jkf.insert_keyframe(kfs_j, jnp.int32(3), jse3.SE3(R, tv), jnp.int32(17), jnp.float32(0.5),
                                obs_lm, uv, w, desc, z)
    t = tkf.insert_keyframe(kfs_t, torch.tensor(3, dtype=torch.int32), tse3.SE3(_t(R), _t(tv)),
                            torch.tensor(17, dtype=torch.int32), torch.tensor(0.5), _t(obs_lm), _t(uv),
                            _t(w), _t(desc), _t(z))
    for f in dataclasses.fields(tkf.Keyframes):
        a, b = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        np.testing.assert_array_equal(a.view(b.dtype) if b.dtype == np.uint32 else a, b, err_msg=f.name)
    assert int(tkf.num_keyframes(t)) == 1


def test_motion_only_gn_matches_jax():
    rng = np.random.default_rng(2)
    N = 120
    jcam = JaxCamera.create(160.0, 160.0, 159.5, 119.5, 320, 240)
    tcam = PinholeCamera.create(160.0, 160.0, 159.5, 119.5, 320, 240)
    pts = np.c_[rng.uniform(-2, 2, (N, 2)), rng.uniform(1, 5, N)].astype(np.float32)
    true = jse3.exp_se3(jnp.asarray([0.02, -0.03, 0.01, 0.05, -0.02, 0.03], jnp.float32))
    uv, _ = jcam.project(true.apply(jnp.asarray(pts)))
    uv = np.asarray(uv) + rng.normal(0, 0.5, (N, 2)).astype(np.float32)
    uv[:10] += 40.0  # outliers
    weights = (rng.random(N) < 0.9).astype(np.float32)
    depth = np.where(rng.random(N) < 0.5, np.asarray(true.apply(jnp.asarray(pts)))[:, 2], 0.0).astype(np.float32)
    for d in (None, depth):
        with jax.disable_jit():
            jr = jpnp.motion_only_gn(jse3.SE3.identity(), pts, uv, weights, jcam,
                                     depth_obs=None if d is None else jnp.asarray(d))
        tr = tpnp.motion_only_gn(tse3.SE3.identity("cpu"), _t(pts), _t(uv), _t(weights), tcam,
                                 depth_obs=None if d is None else _t(d))
        _assert_pose(tr.pose, jr.pose)
        np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
        assert abs(float(tr.rmse) - float(jr.rmse)) <= 1e-4
        assert int(tr.num_inliers) > 80


def test_se3_maps_match_jax():
    rng = np.random.default_rng(3)
    xi = rng.normal(0, 0.8, (64, 6)).astype(np.float32)
    xi[:4, :3] *= 1e-5  # small-angle series branch
    with jax.disable_jit():
        jT = jse3.exp_se3(jnp.asarray(xi))
        jlog = jse3.log_se3(jT)
        jq = jse3.mat_to_quat(jT.R)
        jR = jse3.quat_to_mat(jq)
        jsl = jse3.quat_slerp(jq[:32], jq[32:], 0.3)
        jc = jT @ jT.inverse()
    tT = tse3.exp_se3(_t(xi))
    _assert_pose(tT, jT, GEOM_TOL)
    np.testing.assert_allclose(tse3.log_se3(tT).numpy(), np.asarray(jlog), atol=1e-5)
    np.testing.assert_allclose(tse3.log_se3(tT).numpy(), xi, atol=1e-4)
    tq = tse3.mat_to_quat(tT.R)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=GEOM_TOL)
    np.testing.assert_allclose(tse3.quat_to_mat(tq).numpy(), np.asarray(jR), atol=GEOM_TOL)
    np.testing.assert_allclose(tse3.quat_slerp(tq[:32], tq[32:], 0.3).numpy(), np.asarray(jsl), atol=GEOM_TOL)
    _assert_pose(tT @ tT.inverse(), jc, GEOM_TOL)
    np.testing.assert_array_equal(tse3.hat_so3(_t(xi[:, :3])).numpy(), np.asarray(jse3.hat_so3(jnp.asarray(xi[:, :3]))))


def test_pose_buffer_matches_jax():
    rng = np.random.default_rng(4)
    jb, tb = JaxPoseBuffer(), PoseBuffer()
    for k in range(5):
        T = jse3.exp_se3(jnp.asarray(rng.normal(0, 0.5, 6), jnp.float32))
        jb.register(0.1 * k, jse3.SE3(np.asarray(T.R), np.asarray(T.t)))
        tb.register_lazy(0.1 * k, tse3.SE3(_t(T.R), _t(T.t)), torch.tensor(True))
    tb.register_lazy(0.45, tse3.SE3.identity("cpu"), torch.tensor(False))  # untracked: dropped
    assert len(tb) == len(jb) == 5
    for ts in (-1.0, 0.0, 0.05, 0.17, 0.3999, 0.5):
        a, b = tb.query(ts), jb.query(ts)
        _assert_pose(a, b, GEOM_TOL)
    assert tb.latest() is not None and len(tb.entries()) == 5
    assert PoseBuffer().query(0.0) is None


def test_ate_and_trajectory_io_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    gt, est = [], []
    for i in range(20):
        T = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)).as_matrix())
        gt.append((i, T[:3, :4]))
        noise = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32)).as_matrix())
        est.append((i, (noise @ T)[:3, :4]))
    for scale in (False, True):
        assert tate.ate_rmse(est, gt, with_scale=scale) == jate.ate_rmse(est, gt, with_scale=scale)
    assert tate.rpe_rmse(est, gt, delta=2) == jate.rpe_rmse(est, gt, delta=2)
    path = str(tmp_path / "trajectory.txt")
    tfolder.save_trajectory(path, est)
    for (a, x), (b, y) in zip(tfolder.load_trajectory(path), jax_load_trajectory(path)):
        assert a == b
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(ba_every_kf=1), dict(reassoc_mode=1), dict(focal_x_baseline=40.0), dict(loop_min_gap=30),
], ids=["ba", "reassoc", "stereo", "loop_gap_30"])
def test_formerly_deferred_configurations_run(kw):
    """The configurations the port refused before loop closing and BA
    were ported now build and track: 3 frames of the 160x120 orbit
    (loop checks at every keyframe, a keyframe every other frame)."""
    spec = SyntheticCameraSpec(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120)
    ds = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0)
    c = ds.camera
    cam = PinholeCamera.create(float(c.fx), float(c.fy), float(c.cx), float(c.cy), c.width, c.height)
    tcfg = TrackingConfig(min_inliers=12, match_radius=15.0, keyframe_min_interval=1, keyframe_translation=0.02,
                          max_map_points=512, max_keyframes=8)
    s = SlamSystem(cam, fcfg=FeatureConfig(max_num_keypoints=200, num_levels=2), tcfg=tcfg, device="cpu",
                   ba_window=3, ba_max_points=256, loop_every_kf=1, **kw)
    for i in range(3):
        fr = ds.frame(i)
        info = s.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i)
        assert info.tracked, i
    assert int(s.state.track.kf_counter) >= 2 and int(s.state.n_edges) >= 1


def test_deferred_entry_points_raise(monkeypatch):
    """What cannot run raises: stereo tracking without a baseline, and a
    cuda device without a GPU."""
    cam = PinholeCamera.create(80.0, 80.0, 79.5, 59.5, 160, 120)
    s = SlamSystem(cam, tcfg=TrackingConfig(max_map_points=64, max_keyframes=4), device="cpu")
    with pytest.raises(ValueError, match="focal_x_baseline"):
        s.feed_stereo_frame(np.zeros((120, 160), np.float32), np.zeros((120, 160), np.float32), 0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trajectory_bench.main(["--frames", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        SlamSystem(cam, device="cuda")
