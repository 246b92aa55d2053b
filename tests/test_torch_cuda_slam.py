"""Tests of the PyTorch port's tracking on the GPU: the tracking path
with loop closing off and on (`eval.trajectory_bench`, 150 VGA frames),
BA and PGO from its final state against the CPU, the distributed BA
solver and `refine_map` over a LocalMesh, stereo tracking, `live.run`
with fake cameras, the EVAL matrix's seed-0 rows, the carried steps of
tests/test_torch_lockstep.py, and every ORB pyramid the port builds, card
against CPU bit for bit.

They skip where torch sees no CUDA device. This file imports no JAX, so
that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda*.py
"""

import dataclasses
import glob
import importlib.util
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.ops import hamming, tsdf_fuse

HERE = os.path.dirname(os.path.abspath(__file__))
TRACK_FRAMES = 150  # the tracking path's frames (trajectory_bench)

# Every bound of this file.
TOL = {
    # ATE of a tracked run, m (the repo's north-star bound,
    # tests/test_trajectory_north_star.py)
    "ate_m": 0.05,
    # card vs CPU of one BA window solve, one PGO and the distributed solve
    # (float32, TF32 off; the same operations summed in other orders)
    "dev_vs_cpu": 1e-4,
    # the distributed solve against `solve_window` on the card: poses, points
    "dist_pose": 1e-3, "dist_point": 5e-3,
    # `refine_map` may raise the reprojection rmse by at most this, px
    "refine_rmse_px": 0.5,
    # a stereo-tracked frame's translation error, m
    "stereo_m": 0.1,
    # an EVAL row's ATE against the JAX package's op by op, m
    "eval_ate_m": 0.002,
    # a carried step's pose against the JAX package's op-by-op step
    "lockstep_pose": 1e-5,
}
# the EVAL matrix's seed-0 rows, loop on / off, of the JAX package as it
# stands, run op by op (its source's own float32 operations: scripts/
# lockstep_torch_jax.py --mode free-op-by-op on a CPU), which tracks every
# frame; jitted, XLA contracts multiply-adds and the JAX package loses
# frame 116
EVAL_JAX_SEED0 = {True: {"ate_rmse_m": 0.0100, "lost_frames": 0, "loop_closures": 4},
                  False: {"ate_rmse_m": 0.0152, "lost_frames": 0, "loop_closures": 0}}
LOCKSTEP_DISCRETE = ("tracked", "num_matches", "num_inliers", "inserted_keyframe", "relocalized",
                     "loop_cand", "loop_inliers", "loop_closed", "ba_dropped")
LOCKSTEP_FIXTURES = sorted(glob.glob(os.path.join(HERE, "data", "lockstep_*.npz")))
ZED_VGA, ZED_FX = (672, 376), 350.0  # the ZED's VGA eye size, a rectified focal length like its own
# every pyramid the port builds ((width, height), levels) and the ORB it
# feeds: the facade's default, the live cell's, the tests'
PYRAMID_SHAPES = {
    "640x480_8_levels": ((640, 480), 8, {}),
    "672x376_8_levels": (ZED_VGA, 8, dict(max_num_keypoints=1000, num_levels=3)),
    "320x240_4_levels": ((320, 240), 4, dict(max_num_keypoints=300, num_levels=4)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _load_script(name):
    """A module of scripts/ by file path (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(HERE), "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tracked():
    """`trajectory_bench` at 640x480 over 150 frames on the card, loop
    closing off, then on: {"off": (metrics, Hamming launches), "on":
    (metrics, launches, the system)}."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from ra_slam_tpu_torch.eval import trajectory_bench

    argv = ["--width", "640", "--height", "480", "--frames", str(TRACK_FRAMES)]
    n0 = hamming.LAUNCHES
    off = trajectory_bench.main(argv + ["--no-loop"])
    n1 = hamming.LAUNCHES
    on, slam = trajectory_bench.main(argv, return_system=True)
    return {"off": (off, n1 - n0), "on": (on, hamming.LAUNCHES - n1, slam)}


@pytest.mark.cuda
def test_tracking_loop_off_on_card(tracked):
    """No frame lost, the ATE within the north-star bound, the Hamming
    kernel launched at least once a frame."""
    r, launches = tracked["off"]
    assert r["lost_frames"] == 0 and r["matched_frames"] == TRACK_FRAMES, r
    assert r["ate_rmse_m"] <= TOL["ate_m"], r
    assert launches >= TRACK_FRAMES


@pytest.mark.cuda
def test_tracking_loop_on_closes_on_card(tracked):
    """Loop closing on: no frame lost, at least one closure, at most two
    relocalizations, the ATE within the bound and below loop off's, the
    Hamming kernel launched at least once a frame."""
    r, launches, _ = tracked["on"]
    assert r["lost_frames"] == 0 and r["matched_frames"] == TRACK_FRAMES, r
    assert r["loop_closures"] >= 1 and r["relocalizations"] <= 2, r
    assert r["ate_rmse_m"] <= TOL["ate_m"] and r["ate_rmse_m"] < tracked["off"][0]["ate_rmse_m"], r
    assert launches >= TRACK_FRAMES


@pytest.mark.cuda
def test_ba_and_pgo_cuda_match_cpu(tracked):
    """From the loop-on run's final state, one global-BA window solve and
    one pose-graph optimisation on the card and on the CPU: the largest
    pose and point differences within 1e-4."""
    from ra_slam_tpu_torch.slam.ba import gather_window, solve_window
    from ra_slam_tpu_torch.slam.pose_graph import optimize_pose_graph
    from ra_slam_tpu_torch.utils.convert import slam_state_from_numpy, slam_state_to_numpy

    slam = tracked["on"][2]
    p, cam = slam.params, slam.cam
    on_card = slam.state
    on_cpu = slam_state_from_numpy(slam_state_to_numpy(on_card), "cpu")
    kfc = int(on_card.track.kf_counter)
    start = max(kfc - p.gba_window, 0)

    def ba(s):
        win = gather_window(s.kfs, s.track.lms, kfc, p.gba_window, p.ba_max_points, start=start)
        poses, points, _ = solve_window(win, cam, iterations=p.gba_iterations)
        return poses, torch.where(win.point_ok[:, None], points, 0.0)

    def pgo(s):
        kfs, _ = optimize_pose_graph(s.kfs, s.edges, s.track.kf_counter, max_nodes=s.kfs.capacity,
                                     iterations=p.pgo_iterations)
        return kfs

    (Pg, Xg), (Pc, Xc) = ba(on_card), ba(on_cpu)
    kg, kc = pgo(on_card), pgo(on_cpu)
    diff = lambda a, b: (a.cpu() - b.cpu()).abs().max().item()
    err = {"ba_pose_R": diff(Pg.R, Pc.R), "ba_pose_t": diff(Pg.t, Pc.t), "ba_points": diff(Xg, Xc),
           "pgo_R": diff(kg.R, kc.R), "pgo_t": diff(kg.t, kc.t)}
    assert max(err.values()) <= TOL["dev_vs_cpu"], err


@pytest.mark.cuda
def test_refine_map_over_a_local_mesh(tracked):
    """`refine_map` over `LocalMesh(2)` on the loop-on run's system: at
    least one window, a finite rmse, raised by at most 0.5 px."""
    from ra_slam_tpu_torch.parallel import LocalMesh

    slam = tracked["on"][2]
    r = slam.refine_map(mesh=LocalMesh(2, torch.device("cuda"), axis="ba"))
    assert np.isfinite(r["rmse_after"]) and r["rmse_after"] <= r["rmse_before"] + TOL["refine_rmse_px"], r
    assert r["windows"] >= 1, r


def _ba_problem(device):
    """tests/test_ba.py's problem (6 keyframes on a sideways track, 120
    points at 3-6 m, 200 px focal length at 320x240) perturbed as its
    `_perturb` does (poses 0.02, points 0.05), in the port's types."""
    from ra_slam_tpu_torch.core.camera import PinholeCamera
    from ra_slam_tpu_torch.core.se3 import exp_se3
    from ra_slam_tpu_torch.slam.keyframes import create_keyframes, insert_keyframe
    from ra_slam_tpu_torch.slam.landmarks import create_landmarks

    num_kf, num_pts, F = 6, 120, 160
    cam = PinholeCamera.create(200.0, 200.0, 159.5, 119.5, 320, 240)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-2.0, 2.0, num_pts), rng.uniform(-1.5, 1.5, num_pts),
                    rng.uniform(3.0, 6.0, num_pts)], axis=-1).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)
    kfs = create_keyframes(16, F, "cpu")
    lms = create_landmarks(1024, "cpu")
    lms = dataclasses.replace(lms, pos=lms.pos.index_copy(0, torch.arange(num_pts), t(pts)),
                              valid=lms.valid.index_fill(0, torch.arange(num_pts), True))
    obs_lm = t(np.r_[np.arange(num_pts), -np.ones(F - num_pts)], torch.int32)
    for k in range(num_kf):
        pose = exp_se3(t([0, 0.03 * k, 0, 0.15 * k, 0, 0]))
        uv, z = cam.project(pose.apply(t(pts)))
        w = (z > 0).float() * cam.in_bounds(uv).float()
        kfs = insert_keyframe(kfs, t(k, torch.int32), pose, t(k, torch.int32), t(k / 30.0),
                              obs_lm, torch.cat([uv, torch.zeros(F - num_pts, 2)]),
                              torch.cat([w, torch.zeros(F - num_pts)]), torch.zeros(F, 8, dtype=torch.int32))
    rng = np.random.default_rng(1)
    R, tr = kfs.R.clone(), kfs.t.clone()
    for k in range(1, num_kf):
        noisy = exp_se3(t(rng.normal(0, 0.02, 6))) @ SE3(kfs.R[k], kfs.t[k])
        R[k], tr[k] = noisy.R, noisy.t
    kfs = dataclasses.replace(kfs, R=R, t=tr)
    lms = dataclasses.replace(lms, pos=lms.pos.index_add(0, torch.arange(num_pts),
                                                         t(rng.normal(0, 0.05, (num_pts, 3)))))
    on = lambda x: dataclasses.replace(x, **{f.name: getattr(x, f.name).to(device) for f in dataclasses.fields(x)})
    return cam, on(kfs), on(lms), num_kf


@pytest.mark.cuda
def test_distributed_ba_cuda(cuda):
    """`solve_window_distributed` over 4 LocalMesh shards on the card on
    tests/test_dist_ba.py's window: within 1e-3 (poses) and 5e-3 (points)
    of `solve_window` on the card, and within 1e-4 of itself on the CPU
    (8 GN iterations from a 7 px start leave ~1.5e-5 m on points at
    3-6 m, measured on the H100)."""
    from ra_slam_tpu_torch.parallel import LocalMesh, solve_window_distributed
    from ra_slam_tpu_torch.slam.ba import gather_window, solve_window

    out = {}
    for d in (cuda, torch.device("cpu")):
        cam, kfs, lms, num_kf = _ba_problem(d)
        win = gather_window(kfs, lms, num_kf, 8, 256)
        out[d.type] = (win, solve_window(win, cam, iterations=8),
                       solve_window_distributed(win, cam, LocalMesh(4, d, axis="ba"), iterations=8))
    win, (p1, x1, _), (pd, xd, _) = out["cuda"]
    _, _, (pc, xc, _) = out["cpu"]
    ok = win.point_ok
    diff = lambda a, b: (a.cpu() - b.cpu()).abs().max().item()
    assert diff(pd.t, p1.t) <= TOL["dist_pose"] and diff(xd[ok], x1[ok]) <= TOL["dist_point"]
    err_cpu = {"poses_R": diff(pd.R, pc.R), "poses_t": diff(pd.t, pc.t), "points": diff(xd[ok], xc[ok.cpu()])}
    assert max(err_cpu.values()) <= TOL["dev_vs_cpu"], err_cpu


def _stereo_rig():
    """(spec, baseline, half extents) of the live phase: a 4 x 3 x 4 m room
    at the ZED's VGA eye size, the principal point at the centre (a
    zero-distortion calibration rectifies to itself)."""
    from ra_slam_tpu_torch.io.synthetic import SyntheticCameraSpec

    w, h = ZED_VGA
    spec = SyntheticCameraSpec(fx=ZED_FX, fy=ZED_FX, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
    return spec, 0.12, np.array([2.0, 1.5, 2.0])


def _render_pair(spec, baseline, he, eye, checker=0.5):
    """(left, right, left depth, world_T_left) of a rectified pair: the
    right camera is the left moved by the baseline along its x."""
    from ra_slam_tpu_torch.io.synthetic import look_at, render_box_room

    w_T_l = look_at(np.asarray(eye, np.float64), np.array([0.0, 0.0, 1.5]))
    w_T_r = w_T_l.copy()
    w_T_r[:3, 3] += w_T_l[:3, 0] * baseline
    left, depth, _, _ = render_box_room(spec, w_T_l, he, checker=checker)
    right = render_box_room(spec, w_T_r, he, checker=checker)[0]
    return left, right, depth, w_T_l


@pytest.mark.cuda
def test_stereo_tracking_on_card(cuda):
    """6 rectified VGA pairs (tests/test_stereo.py's pair at 240x180, the
    intrinsics scaled) through `SlamSystem.feed_stereo_frame`: every frame
    tracked within 0.1 m, the Hamming kernel launched every frame."""
    from ra_slam_tpu_torch.core.camera import PinholeCamera
    from ra_slam_tpu_torch.core.config import FeatureConfig, TrackingConfig
    from ra_slam_tpu_torch.core.se3 import log_se3
    from ra_slam_tpu_torch.io.synthetic import SyntheticCameraSpec
    from ra_slam_tpu_torch.slam.system import SlamSystem

    s = 640 / 240
    spec = SyntheticCameraSpec(fx=120.0 * s, fy=120.0 * s, cx=120.0 * s - 0.5, cy=90.0 * s - 0.5,
                               width=640, height=480)
    baseline, he = 0.12, np.array([2.0, 1.5, 2.0])
    cam = PinholeCamera.create(spec.fx, spec.fy, spec.cx, spec.cy, spec.width, spec.height)
    slam = SlamSystem(
        cam, fcfg=FeatureConfig(max_num_keypoints=1000, num_levels=3),
        tcfg=TrackingConfig(min_inliers=12, match_radius=30.0).scaled(s),
        ba_window=4, ba_max_points=1024, ba_iterations=3,
        focal_x_baseline=spec.fx * baseline, max_disparity=int(48 * s), device=cuda,
    )
    n0 = hamming.LAUNCHES
    for i in range(6):
        rgb_l, rgb_r, _, w_T_l = _render_pair(spec, baseline, he, (0.3 - 0.03 * i, 0.02 * i, 0.05 * i))
        gt = SE3.from_matrix(torch.as_tensor(np.linalg.inv(w_T_l), dtype=torch.float32, device=cuda))
        info = slam.feed_stereo_frame(rgb_l, rgb_r, float(i), pose_hint=gt if i == 0 else None)
        assert info.tracked, i
        err = torch.linalg.vector_norm(log_se3(info.pose @ gt.inverse())[3:]).item()
        assert err < TOL["stereo_m"], (i, err)
    assert hamming.LAUNCHES - n0 >= 6


class _FakeZedStream:
    """`ZedNativeCamera`'s interface: rectified VGA pairs of the room
    along tests/test_live.py's path, rendered and put through the
    rectifier as ZedNativeCamera does."""

    def __init__(self, rectifier):
        self.rectifier, self.i, self.poses = rectifier, 0, {}

    def get_stereo_frame(self):
        spec, baseline, he = _stereo_rig()
        i = self.i
        left, right, _, w_T_l = _render_pair(spec, baseline, he, (0.3 - 0.01 * i, 0.005 * i, 0.01 * i))
        left, right = self.rectifier.rectify(left, right)
        self.poses[i] = np.linalg.inv(w_T_l.astype(np.float64))[:3]
        self.i += 1
        return left, right, i / 30.0

    def close(self):
        pass


class _FakeRgbdFromZed:
    """The RGB-D camera in the `ZedDepthCamera` role: the left image and
    its dense stereo depth on the card. Waits for the first tracked pose,
    as tests/test_live.py's fake does, so that mapping overlaps tracking."""

    def __init__(self, system, rectifier, fxb, dev):
        from ra_slam_tpu_torch.io.cameras import ZedDepthCamera

        self.zed = ZedDepthCamera(rectifier, fxb, max_disparity=64, device=dev, cam=_FakeZedStream(rectifier))
        self.system, self.started = system, False

    def get_rgbd_frame(self):
        if not self.started:
            t0 = time.monotonic()
            while len(self.system.slam.pose_buffer) == 0 and time.monotonic() - t0 < 120.0:
                time.sleep(0.05)
            self.started = True
        _, (rgb, depth, ts) = self.zed.get_stereo_and_rgbd_frame()
        return rgb, depth, ts + 0.004  # a slightly offset clock, like a real rig


@pytest.mark.cuda
def test_live_run_on_card(cuda, tmp_path):
    """`live.run` on the card with fake cameras for 60 frames: rectified
    672x376 pairs feed the tracking thread, the left image with its dense
    stereo depth (io/cameras.py:ZedDepthCamera) the mapping thread, which
    segments it with the default-width UNet (random weights, from a
    checkpoint the port saves). Both threads reach 60 frames, the ATE
    within 0.05 m, at least 30 frames fused without allocation failure,
    the UNet run on every fused frame with its maps and the fused voxels'
    probabilities in [0, 1], a preview PNG of the pair's size, both
    kernels launched."""
    from ra_slam_tpu_torch.core.config import FeatureConfig, SystemConfig, TrackingConfig, TsdfConfig
    from ra_slam_tpu_torch.core.rectify import CalibMono, CalibStereo, StereoRectifier, rewrite_camera_config
    from ra_slam_tpu_torch.eval.ate import ate_rmse
    from ra_slam_tpu_torch.io.png import read_png
    from ra_slam_tpu_torch.models.segmentation import InferenceEngine
    from ra_slam_tpu_torch.pipeline import live
    from ra_slam_tpu_torch.pipeline.system import RaSlamSystem

    frames = 60
    spec, baseline, _ = _stereo_rig()
    mono = CalibMono(spec.fx, spec.fy, spec.cx, spec.cy, [0.0] * 5)
    rectifier = StereoRectifier(ZED_VGA, CalibStereo(mono, mono, [0.0, 0.0, 0.0], [-baseline, 0.0, 0.0]), device=cuda)
    w, h = ZED_VGA
    cfg = rewrite_camera_config(SystemConfig(
        tsdf=TsdfConfig(voxel_size=0.02, truncation=0.12, max_depth=6.0, log2_num_blocks=15, log2_hash_size=17,
                        max_visible_blocks=1 << 14, max_new_blocks=1 << 15, width=w, height=h),
        feature=FeatureConfig(max_num_keypoints=1000, num_levels=3),
        tracking=TrackingConfig(min_inliers=10, match_radius=30.0).scaled(w / 240),
    ), rectifier)
    ckpt, out = str(tmp_path / "seg.msgpack"), str(tmp_path / "previews")
    InferenceEngine("__random__", w, h, device=cuda).save(ckpt)
    system = RaSlamSystem(cfg, cuda, segmentation_model=ckpt)
    ranges, segment = [], system.seg.segment

    def segment_spy(rgb):  # the maps' (min, max), read after the run
        ht, lt = segment(rgb)
        ranges.append(torch.stack([ht.min(), ht.max(), lt.min(), lt.max()]))
        return ht, lt

    system.seg.segment = segment_spy
    stereo = _FakeZedStream(rectifier)
    rgbd = _FakeRgbdFromZed(system, rectifier, cfg.camera.focal_x_baseline, cuda)
    f0, h0 = tsdf_fuse.LAUNCHES, hamming.LAUNCHES
    _, n_slam, n_tsdf = live.run(system, stereo, rgbd, out_dir=out, render_every_s=2.0, stop_after_frames=frames)
    fuse_launches, ham_launches = tsdf_fuse.LAUNCHES - f0, hamming.LAUNCHES - h0
    del system.seg.segment
    pngs = sorted(f for f in os.listdir(out) if f.startswith("live_"))
    assert n_slam >= frames and n_tsdf >= frames
    assert ate_rmse(system.slam.trajectory(), sorted(stereo.poses.items()))["ate_rmse"] <= TOL["ate_m"]
    assert system.num_integrated >= frames // 2 and int(system.map.alloc_failures) == 0
    assert pngs and read_png(os.path.join(out, pngs[0])).shape == (h, w, 4)
    ranges = torch.stack(ranges).cpu().numpy()
    assert len(ranges) >= system.num_integrated and np.isfinite(ranges).all()
    assert ranges[:, [0, 2]].min() >= 0.0 and ranges[:, [1, 3]].max() <= 1.0
    probs = system.semantic_voxels()[:, 4]
    assert len(probs) and np.isfinite(probs).all() and probs.min() >= 0.0 and probs.max() <= 1.0
    assert ham_launches >= frames and fuse_launches >= system.num_integrated


@pytest.mark.cuda
def test_eval_seed0_rows_on_card(cuda):
    """The EVAL matrix's seed-0 rows (hardened scene, 150 VGA frames) on
    the card, loop closing on and off: a closure with it on and a lower
    ATE than off; each row's lost frames and closures those of the JAX
    package run op by op, its ATE within 2 mm of that run's; the Hamming
    kernel launched every frame."""
    from ra_slam_tpu_torch.eval.trajectory_bench import run_trajectory_eval

    ev = _load_script("gen_eval_torch")
    n0 = hamming.LAUNCHES
    rows = {loop: run_trajectory_eval(n_frames=ev.N_FRAMES, width=ev.W, height=ev.H, scene_kw=ev.HARD, seed=0,
                                      loop_closure=loop, device="cuda") for loop in (True, False)}
    assert hamming.LAUNCHES - n0 >= 2 * ev.N_FRAMES
    assert rows[True]["loop_closures"] >= 1 and rows[True]["ate_rmse_m"] < rows[False]["ate_rmse_m"], rows
    for loop, r in rows.items():
        want = EVAL_JAX_SEED0[loop]
        assert (r["lost_frames"], r["loop_closures"]) == (want["lost_frames"], want["loop_closures"]), (loop, r)
        assert abs(r["ate_rmse_m"] - want["ate_rmse_m"]) <= TOL["eval_ate_m"], (loop, r)


def _lockstep_fixture(path):
    """(frame, row, the JAX state before it as nested namespaces, the JAX
    op-by-op step's FrameInfo) of one tests/data/lockstep_*.npz
    (tests/data/make_lockstep_fixtures.py)."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    root: dict = {}
    for key, v in d.items():
        if key.startswith("before."):
            node = root
            parts = key[len("before."):].split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    ns = lambda x: SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v for k, v in x.items()})
    info = {k[len("info."):]: v for k, v in d.items() if k.startswith("info.")}
    return int(d["meta.frame"]), str(d["meta.row"]), ns(root), info


def _eval_row(ev, name):
    """(seed, loop closing, other keywords) of a named row of the EVAL
    matrix (the seed-0 baseline with loop closing is `baseline`)."""
    found = {}

    def run(tag, **kw):
        if tag != "baseline" or kw.get("loop_closure", True):
            found.setdefault(tag, kw)

    ev.matrix(run, seeds=(0,), ablation_seeds=(0,))
    kw = dict(found[name])
    return kw.pop("seed", 0), kw.pop("loop_closure", True), kw


@pytest.mark.cuda
@pytest.mark.parametrize("path", LOCKSTEP_FIXTURES, ids=[os.path.basename(p)[:-4] for p in LOCKSTEP_FIXTURES])
def test_carried_step_on_card(cuda, path):
    """A carried step of tests/test_torch_lockstep.py on the card: the
    frame's ORB keypoints (uv, valid, score, descriptors) on the card
    equal the CPU's bit for bit; then from the fixture's JAX state one
    `feed_rgbd_frame` on the card gives every discrete `FrameInfo` field
    of the JAX package's op-by-op step, the pose within 1e-5, and
    launches the Hamming kernel."""
    from ra_slam_tpu_torch.eval.trajectory_bench import tracking_setup
    from ra_slam_tpu_torch.features.orb import detect_and_describe
    from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
    from ra_slam_tpu_torch.utils.convert import slam_state_from_numpy

    ev = _load_script("gen_eval_torch")
    frame, row, before, info = _lockstep_fixture(path)
    seed, loop, kw = _eval_row(ev, row)
    ds, slam = tracking_setup(ev.W, ev.H, 0.005, seed, ev.HARD, "cuda", loop, **kw)
    gray = rgb_to_gray(torch.as_tensor(ds.frame(frame).rgb))
    kc, kg = detect_and_describe(gray, slam.fcfg), detect_and_describe(gray.to(cuda), slam.fcfg)
    for f in ("uv", "valid", "score", "desc"):
        assert torch.equal(getattr(kc, f), getattr(kg, f).cpu()), f
    slam.state = slam_state_from_numpy(before, "cuda")
    fr = ds.frame(frame)
    n0 = hamming.LAUNCHES
    out = slam.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=frame)
    assert hamming.LAUNCHES > n0
    got = {k: int(getattr(out, k)) for k in LOCKSTEP_DISCRETE}
    assert got == {k: int(info[k]) for k in LOCKSTEP_DISCRETE}
    assert np.abs(out.pose.t.cpu().numpy() - info["t"]).max() <= TOL["lockstep_pose"]
    assert np.abs(out.pose.R.cpu().numpy() - info["R"]).max() <= TOL["lockstep_pose"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PYRAMID_SHAPES))
def test_pyramid_and_orb_card_equal_cpu(cuda, case):
    """At every input shape the port builds a pyramid for, a frame of the
    EVAL scene: every level, its blur and the ORB keypoints (uv, valid,
    score, descriptors; at VGA the facade's default `FeatureConfig`, at
    672x376 the live cell's 1000 keypoints on 3 levels) on the card equal
    the CPU's bit for bit."""
    from ra_slam_tpu_torch.core.config import FeatureConfig
    from ra_slam_tpu_torch.features.orb import detect_and_describe
    from ra_slam_tpu_torch.features.pyramid import build_pyramid, gaussian_blur, rgb_to_gray
    from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    (w, h), levels, feature_kw = PYRAMID_SHAPES[case]
    fcfg, f = FeatureConfig(**feature_kw), w / 2.0
    spec = SyntheticCameraSpec(fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0, width=w, height=h)
    rgb = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, depth_noise=0.005, clutter=6).frame(1).rgb
    gray = rgb_to_gray(torch.as_tensor(rgb))
    lc, lg = build_pyramid(gray, levels), build_pyramid(gray.to(cuda), levels)
    assert len(lc) == len(lg) == levels
    for i, (a, b) in enumerate(zip(lc, lg)):
        assert torch.equal(a, b.cpu()), f"level {i}"
        assert torch.equal(gaussian_blur(a), gaussian_blur(b).cpu()), f"blur {i}"
    kc, kg = detect_and_describe(gray, fcfg), detect_and_describe(gray.to(cuda), fcfg)
    for k in ("uv", "valid", "score", "desc"):
        assert torch.equal(getattr(kc, k), getattr(kg, k).cpu()), k
