"""Sparse visual SLAM system: tracking, keyframes, bundle adjustment and
loop closing (counterpart of `ra_slam_tpu/slam/system.py`).

Per frame: ORB on the device, then `slam_frame_step`: initialise or
track, relocalize when lost, insert a keyframe with its odometry edge,
run windowed BA on it (`ba_every_kf`), and check it for a loop; a
verified, consistent loop adds its edge, optimises the pose graph,
moves the landmarks with their anchor keyframes and runs global BA
sweeps. The JAX package fuses that decision tree into one program under
`lax.cond`; here each branch is a Python `if` on a device boolean, which
waits for the device, and so is global BA's chunk count. `SYNCS` counts
those reads (a few per frame); making the step sync-free is later work.

Stereo frames (`feed_stereo_frame`) get per-keypoint depth from a
rectified pair and then take the RGB-D path. `refine_map` with a `mesh`
(the distributed solver) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import FeatureConfig, TrackingConfig
from ra_slam_tpu_torch.core.se3 import SE3, log_se3, where_pose
from ra_slam_tpu_torch.core.device import resolve_device
from ra_slam_tpu_torch.features.orb import Keypoints, detect_and_describe, keypoint_capacity
from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
from ra_slam_tpu_torch.features.stereo import sparse_depth_image, stereo_keypoint_depth
from ra_slam_tpu_torch.slam.ba import (
    gather_window,
    global_bundle_adjustment,
    local_bundle_adjustment,
    scatter_window,
    solve_window,
)
from ra_slam_tpu_torch.slam.keyframes import (
    Keyframes,
    create_keyframes,
    insert_keyframe,
    refresh_observations,
)
from ra_slam_tpu_torch.slam.landmarks import scatter_rows
from ra_slam_tpu_torch.slam.loop_closure import LoopCandidate, detect_loop, relocalize
from ra_slam_tpu_torch.slam.pose_graph import (
    PoseGraphEdges,
    add_edge,
    correct_landmarks,
    create_edges,
    odometry_edge,
    optimize_pose_graph,
)
from ra_slam_tpu_torch.slam.tracker import (
    TrackState,
    create_track_state,
    initialize_from_frame,
    insert_keyframe_landmarks,
    track_frame,
)
from ra_slam_tpu_torch.utils.pose_buffer import PoseBuffer
from ra_slam_tpu_torch.utils.profiling import TRACE

SYNCS = 0  # host reads of device values in slam_frame_step
TRACE.expose("slam.syncs", lambda: SYNCS)


def _host_bool(t: torch.Tensor) -> bool:
    """Read a device boolean on the host (waits for the device; a
    `wait` span named after the reading stage)."""
    global SYNCS
    SYNCS += 1
    with TRACE.wait():
        return bool(t)


def _host_int(t: torch.Tensor) -> int:
    """Read a device integer on the host (waits for the device)."""
    global SYNCS
    SYNCS += 1
    with TRACE.wait():
        return int(t)


@dataclass(frozen=True)
class SlamState:
    """Tracker + keyframe database + pose graph + per-frame statistics,
    all fixed capacity, all on one device."""

    track: TrackState
    kfs: Keyframes
    edges: PoseGraphEdges
    n_edges: torch.Tensor  # int32
    n_loops: torch.Tensor  # int32 accepted loop closures
    n_relocs: torch.Tensor  # int32 accepted relocalizations
    # per-frame matched-trajectory statistics, in fed order
    fs_ref: torch.Tensor  # [Fc] int32 reference keyframe slot
    fs_relR: torch.Tensor  # [Fc, 3, 3] cam_T_keyframe rotation
    fs_relt: torch.Tensor  # [Fc, 3]
    fs_tracked: torch.Tensor  # [Fc] bool
    n_frames: torch.Tensor  # int32
    # loop-detection temporal-consistency state
    loop_prev_cand: torch.Tensor  # int32 candidate of the last detection
    loop_streak: torch.Tensor  # int32 consecutive consistent detections


@dataclass(frozen=True)
class StepParams:
    """Parameters of the frame step (the JAX package's, same defaults)."""

    ba_window: int = 8
    ba_max_points: int = 4096
    ba_iterations: int = 6
    ba_every_kf: int = 1
    ba_fixed: int = 4
    ba_pose_prior: float = 2e3
    loop_every_kf: int = 5
    loop_min_gap: int = 30
    loop_min_score: float = 0.05
    loop_min_inliers: int = 25
    loop_max_rmse: float = 3.0
    loop_consistency: int = 2
    loop_max_corr_t: float = 1.0
    loop_max_corr_r: float = 0.6
    reloc_min_inliers: int = 20
    reloc_max_rmse: float = 3.0
    reloc_min_score: float = 0.1
    pgo_iterations: int = 8
    gba_after_loop: bool = True
    gba_window: int = 16
    gba_iterations: int = 4
    gba_sweeps: int = 2
    reassoc_mode: int = 0
    reassoc_gate: float = 8.0


_INFO_FIELDS = (
    "tracked", "num_inliers", "num_matches", "inserted_keyframe", "ba_rmse",
    "loop_closed", "relocalized", "loop_cand", "loop_inliers", "loop_rmse",
    "loop_delta_t", "loop_delta_r", "track_rmse", "jump_t", "jump_r",
    "ba_dropped", "ba_shift", "pgo_shift",
)


class FrameInfo:
    """Per-frame feedback: `pose` stays on the device; the scalar fields
    (`_INFO_FIELDS`) come to the host together, in one copy, on the
    first read of any of them."""

    def __init__(self, R: torch.Tensor, t: torch.Tensor, **dev):
        self._R, self._t = R, t
        self._dev = dev
        self._host = None

    def _pull(self) -> dict:
        if self._host is None:
            with TRACE.wait("frame_info.pull"):
                vals = torch.stack([self._dev[k].to(torch.float64) for k in _INFO_FIELDS]).cpu().numpy()
            self._host = dict(zip(_INFO_FIELDS, vals.tolist()))
        return self._host

    @property
    def pose(self) -> SE3:
        return SE3(self._R, self._t)

    def __getattr__(self, name):
        if name in _INFO_FIELDS:
            v = self._pull()[name]
            kind = self._dev[name].dtype
            if kind == torch.bool:
                return bool(v)
            return int(v) if not kind.is_floating_point else float(v)
        raise AttributeError(name)

    @property
    def loop_delta(self) -> tuple:
        return (self.loop_delta_t, self.loop_delta_r)

    def block(self) -> "FrameInfo":
        self._t.cpu()
        return self


def _maybe_add_edge(state: SlamState, ok, i, j, z: SE3, weight) -> SlamState:
    """Append a pose-graph edge iff `ok` and capacity remains."""
    cap = state.edges.capacity
    ok = ok & (state.n_edges < cap)
    slot = torch.clamp(state.n_edges, max=cap - 1)
    new = add_edge(state.edges, slot, i, j, z, weight)
    edges = PoseGraphEdges(**{
        f.name: torch.where(ok, getattr(new, f.name), getattr(state.edges, f.name))
        for f in dataclasses.fields(PoseGraphEdges)
    })
    return dataclasses.replace(state, edges=edges, n_edges=state.n_edges + ok.to(torch.int32))


def _newest_kf(state: SlamState) -> SE3:
    return state.kfs.pose(torch.clamp(state.track.kf_counter - 1, min=0).long())


def _propagate_kf_correction(state: SlamState, old_kf: SE3, kfs: Keyframes, lms) -> SlamState:
    """After an optimiser moved the keyframes, re-anchor the tracker's
    pose on the newest keyframe: current = (current ∘ old⁻¹) ∘ new."""
    new_kf = kfs.pose(torch.clamp(state.track.kf_counter - 1, min=0).long())
    rel = state.track.pose @ old_kf.inverse()
    track = dataclasses.replace(state.track, pose=rel @ new_kf, last_kf_pose=new_kf, lms=lms)
    return dataclasses.replace(state, track=track, kfs=kfs)


def _ba_step(state: SlamState, cam, p: StepParams):
    """Windowed BA on the newest keyframes (rows repaired first when
    `reassoc_mode` is set). Returns (state, rmse, points dropped, how
    far the newest keyframe moved)."""
    old_kf = _newest_kf(state)
    kfs = state.kfs
    if p.reassoc_mode:
        kfs, _ = refresh_observations(kfs, state.track.lms, cam, p.reassoc_gate, p.reassoc_mode)
    kfs, lms, stats = local_bundle_adjustment(
        kfs, state.track.lms, state.track.kf_counter, cam,
        window=p.ba_window, max_points=p.ba_max_points, iterations=p.ba_iterations,
        n_fixed=p.ba_fixed, pose_prior=p.ba_pose_prior,
    )
    state = _propagate_kf_correction(state, old_kf, kfs, lms)
    shift = torch.linalg.vector_norm(_newest_kf(state).t - old_kf.t)
    return state, stats.rmse_after, stats.points_dropped, shift


def _gba_step(state: SlamState, cam, p: StepParams):
    """Map-wide BA sweeps; the chunk count follows the keyframe count,
    read on the host here."""
    old_kf = _newest_kf(state)
    kfs, lms, stats = global_bundle_adjustment(
        state.kfs, state.track.lms, _host_int(state.track.kf_counter), cam,
        window=p.gba_window, max_points=p.ba_max_points,
        iterations=p.gba_iterations, sweeps=p.gba_sweeps,
    )
    return _propagate_kf_correction(state, old_kf, kfs, lms), stats.rmse_after


def _loop_close_step(state: SlamState, loop: LoopCandidate, query_slot, p: StepParams):
    """Add the verified loop edge, optimise the pose graph, move the
    landmarks and the tracker's pose with it. Returns (state, how far
    the query keyframe moved, PGO stats)."""
    state = _maybe_add_edge(
        state, torch.ones((), dtype=torch.bool, device=loop.cand.device), query_slot,
        torch.clamp(loop.cand, min=0), loop.rel_pose, 2.0,
    )
    old_R, old_t = state.kfs.R, state.kfs.t
    old_kf = _newest_kf(state)
    with TRACE.span("slam.pgo"):
        kfs, pgo_stats = optimize_pose_graph(
            state.kfs, state.edges, state.track.kf_counter,
            max_nodes=state.kfs.capacity, iterations=p.pgo_iterations,
        )
    q = query_slot.long()
    pgo_shift = torch.linalg.vector_norm(kfs.t[q] - old_t[q])
    lms = correct_landmarks(state.track.lms, old_R, old_t, kfs)
    state = _propagate_kf_correction(state, old_kf, kfs, lms)
    return dataclasses.replace(state, n_loops=state.n_loops + 1), pgo_shift, pgo_stats


def _reloc_step(state: SlamState, kp: Keypoints, cam, tcfg, p: StepParams):
    """Relocalize a lost frame against the keyframe database; on
    acceptance tracking resumes from the recovered pose at zero
    velocity."""
    tr = state.track
    res = relocalize(
        state.kfs, tr.lms, kp.desc, kp.valid, kp.uv, tr.kf_counter, cam, tcfg,
        min_inliers=p.reloc_min_inliers, max_rmse=p.reloc_max_rmse,
        min_score=p.reloc_min_score,
    )
    acc = res.accepted
    track = dataclasses.replace(
        tr,
        pose=where_pose(acc, res.pose, tr.pose),
        velocity=torch.where(acc, 0.0, tr.velocity),
        lost=tr.lost & ~acc,
        bad_streak=torch.where(acc, 0, tr.bad_streak).to(torch.int32),
    )
    return dataclasses.replace(state, track=track, n_relocs=state.n_relocs + acc.to(torch.int32)), acc


def _record_stats(state: SlamState) -> SlamState:
    """Write this frame's (reference keyframe, cam_T_keyframe, tracked)
    row, dropped past the capacity."""
    ref = torch.clamp(state.track.kf_counter - 1, min=0)
    rel = state.track.pose @ state.kfs.pose(ref.long()).inverse()
    i = state.n_frames.reshape(1)
    keep = torch.ones_like(i, dtype=torch.bool)
    row = lambda x, v: scatter_rows(x, i, v[None], keep)
    return dataclasses.replace(
        state,
        fs_ref=row(state.fs_ref, ref),
        fs_relR=row(state.fs_relR, rel.R),
        fs_relt=row(state.fs_relt, rel.t),
        fs_tracked=row(state.fs_tracked, ~state.track.lost),
        n_frames=state.n_frames + 1,
    )


def _loop_check(s: SlamState, new_slot, cam, tcfg, p: StepParams):
    """Detect and verify a loop for keyframe `new_slot` and update the
    consistency state: a loop closes after `loop_consistency`
    consecutive detections of nearly the same candidate whose implied
    correction is small. Returns (state, loop, close_now, diagnostics)."""
    loop = detect_loop(
        s.kfs, s.track.lms, new_slot, s.track.kf_counter, cam=cam, tcfg=tcfg,
        min_gap=p.loop_min_gap, min_score=p.loop_min_score,
        min_inliers=p.loop_min_inliers, max_rmse=p.loop_max_rmse,
    )
    safe_c = torch.clamp(loop.cand, min=0).long()
    q_pose, c_pose = s.kfs.pose(new_slot.long()), s.kfs.pose(safe_c)
    delta = log_se3(loop.rel_pose @ (q_pose @ c_pose.inverse()).inverse())
    dt, dr = torch.linalg.vector_norm(delta[3:]), torch.linalg.vector_norm(delta[:3])
    acc = loop.accepted & (dt <= p.loop_max_corr_t) & (dr <= p.loop_max_corr_r)
    consistent = acc & ((loop.cand - s.loop_prev_cand).abs() <= 2)
    streak = torch.where(consistent, s.loop_streak + 1, acc.to(torch.int32))
    close_now = acc & (streak >= p.loop_consistency) & (s.n_edges < s.edges.capacity)
    s = dataclasses.replace(
        s,
        loop_prev_cand=torch.where(acc, loop.cand, -(10**6)).to(torch.int32),
        loop_streak=torch.where(close_now, 0, streak).to(torch.int32),
    )
    return s, loop, close_now, (loop.cand, loop.num_inliers, loop.rmse, dt, dr)


def _close(s: SlamState, loop: LoopCandidate, new_slot, cam, p: StepParams):
    """The close branch: PGO and landmark correction, then global BA
    and the row repair as configured. Returns (state, GBA rmse, PGO
    shift of the query keyframe)."""
    s, pgo_shift, _ = _loop_close_step(s, loop, new_slot, p)
    gba_rmse = None
    if p.gba_after_loop:
        with TRACE.span("slam.gba"):
            s, gba_rmse = _gba_step(s, cam, p)
    if p.reassoc_mode:
        kfs, _ = refresh_observations(s.kfs, s.track.lms, cam, p.reassoc_gate, p.reassoc_mode)
        s = dataclasses.replace(s, kfs=kfs)
    return s, gba_rmse, pgo_shift


def slam_frame_step(
    state: SlamState,
    kp: Keypoints,
    depth: torch.Tensor,  # [H, W] float32 meters (0 = invalid)
    fid: torch.Tensor,  # int32
    ts: torch.Tensor,  # float32 seconds
    pose0: SE3,  # initialization pose (first frame only)
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    p: StepParams,
) -> Tuple[SlamState, FrameInfo]:
    """One frame: initialise or track, relocalize when lost, insert a
    keyframe when needed, with its odometry edge, windowed BA and loop
    check, and close a loop when one is verified."""
    dev = depth.device
    nan = torch.full((), float("nan"), device=dev)
    f = torch.zeros((), dtype=torch.bool, device=dev)
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    info = dict(
        num_inliers=i0, num_matches=i0, inserted_keyframe=f, ba_rmse=nan,
        loop_closed=f, relocalized=f, loop_cand=i0 - 1, loop_inliers=i0,
        loop_rmse=nan, loop_delta_t=nan, loop_delta_r=nan, track_rmse=nan,
        jump_t=nan, jump_r=nan, ba_dropped=i0, ba_shift=nan, pgo_shift=nan,
    )

    if not _host_bool(state.track.initialized):
        with TRACE.span("slam.init"):
            track, lm_idx, obs_z = initialize_from_frame(state.track, kp, depth, cam, pose0, tcfg)
            obs_w = (kp.valid & (lm_idx >= 0)).to(torch.float32)
            kfs = insert_keyframe(state.kfs, i0, track.pose, fid, ts, lm_idx, kp.uv, obs_w, kp.desc, obs_z)
        with TRACE.span("slam.record"):
            state = _record_stats(dataclasses.replace(state, track=track, kfs=kfs))
        info.update(inserted_keyframe=~f)
        return state, FrameInfo(track.pose.R, track.pose.t, tracked=~f, **info)

    with TRACE.span("slam.track"):
        track, res = track_frame(state.track, kp, depth, cam, tcfg)
    state = dataclasses.replace(state, track=track)
    info.update(
        num_inliers=res.num_inliers, num_matches=res.num_matches,
        track_rmse=res.rmse, jump_t=res.jump_t, jump_r=res.jump_r,
    )
    if _host_bool(track.lost):
        with TRACE.span("slam.reloc"):
            state, info["relocalized"] = _reloc_step(state, kp, cam, tcfg, p)

    if _host_bool(res.need_keyframe):
        with TRACE.span("slam.keyframe"):
            slot = state.track.kf_counter
            track2, obs_lm, obs_z = insert_keyframe_landmarks(state.track, kp, depth, res.lm_idx, cam, tcfg)
            # a tracked match is a keyframe observation only if GN kept it
            track_ok = torch.where(res.lm_idx >= 0, res.inlier, True)
            obs_w = (kp.valid & (obs_lm >= 0) & track_ok).to(torch.float32)
            kfs = insert_keyframe(state.kfs, slot, track2.pose, fid, ts, obs_lm, kp.uv, obs_w, kp.desc, obs_z)
            state = dataclasses.replace(state, track=track2, kfs=kfs)
            kfc = track2.kf_counter
            prev, new_slot = torch.clamp(kfc - 2, min=0), kfc - 1
            z = odometry_edge(kfs.pose(prev.long()), kfs.pose(new_slot.long()))
            state = _maybe_add_edge(state, kfc >= 2, prev, new_slot, z, 1.0)
            info.update(inserted_keyframe=~f)
            if p.ba_every_kf == 1 or (p.ba_every_kf > 1 and _host_bool(kfc % p.ba_every_kf == 0)):
                with TRACE.span("slam.ba"):
                    state, ba_rmse, ba_dropped, ba_shift = _ba_step(state, cam, p)
                info.update(ba_rmse=ba_rmse, ba_dropped=ba_dropped, ba_shift=ba_shift)
            if _host_bool((kfc % p.loop_every_kf == 0) & (kfc >= 2)):
                with TRACE.span("slam.loop_check"):
                    state, loop, close_now, (cand, inl, rmse, dt, dr) = _loop_check(state, new_slot, cam, tcfg, p)
                info.update(loop_cand=cand, loop_inliers=inl, loop_rmse=rmse, loop_delta_t=dt, loop_delta_r=dr)
                if _host_bool(close_now):
                    with TRACE.span("slam.close"):
                        state, gba_rmse, pgo_shift = _close(state, loop, new_slot, cam, p)
                    info.update(loop_closed=~f, pgo_shift=pgo_shift)
                    if gba_rmse is not None:
                        # a closure reports its global BA's rmse (JAX's merge)
                        info.update(ba_rmse=torch.where(torch.isnan(gba_rmse), info["ba_rmse"], gba_rmse))

    with TRACE.span("slam.record"):
        state = _record_stats(state)
    pose = state.track.pose
    return state, FrameInfo(pose.R, pose.t, tracked=~state.track.lost, **info)


def create_slam_state(tcfg: TrackingConfig, num_features: int, max_frames: int, device) -> SlamState:
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return SlamState(
        track=create_track_state(tcfg.max_map_points, device),
        kfs=create_keyframes(tcfg.max_keyframes, num_features, device),
        edges=create_edges(2 * tcfg.max_keyframes, device),
        n_edges=i32(0),
        n_loops=i32(0),
        n_relocs=i32(0),
        fs_ref=torch.zeros(max_frames, dtype=torch.int32, device=device),
        fs_relR=torch.eye(3, device=device).expand(max_frames, 3, 3).contiguous(),
        fs_relt=torch.zeros(max_frames, 3, device=device),
        fs_tracked=torch.zeros(max_frames, dtype=torch.bool, device=device),
        n_frames=i32(0),
        loop_prev_cand=i32(-(10**6)),
        loop_streak=i32(0),
    )


class SlamSystem:
    """Host facade: feed frames, get poses (the JAX package's
    `SlamSystem` API, on one torch device)."""

    def __init__(
        self,
        cam: PinholeCamera,
        fcfg: FeatureConfig = FeatureConfig(),
        tcfg: TrackingConfig = TrackingConfig(),
        ba_window: int = 8,
        ba_max_points: int = 4096,
        ba_iterations: int = 6,
        ba_every_kf: int = 0,
        ba_fixed: int = 4,
        ba_pose_prior: float = 2e3,
        loop_every_kf: int = 5,
        loop_min_gap: int = 30,
        loop_min_score: float = 0.05,
        loop_min_inliers: int = 25,
        loop_max_rmse: float = 3.0,
        loop_consistency: int = 2,
        loop_max_corr_t: float = 1.0,
        loop_max_corr_r: float = 0.6,
        reloc_min_inliers: int = 20,
        reloc_max_rmse: float = 3.0,
        reloc_min_score: float = 0.1,
        pgo_iterations: int = 8,
        gba_after_loop: bool = True,
        gba_window: int = 16,
        gba_iterations: int = 4,
        gba_sweeps: int = 2,
        focal_x_baseline: float = 0.0,
        max_disparity: int = 64,
        max_frames: int = 16384,
        reassoc_mode: int = 0,
        reassoc_gate: float = 8.0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cam = cam
        self.fcfg = fcfg
        self.tcfg = tcfg
        self.focal_x_baseline = focal_x_baseline
        self.max_disparity = max_disparity
        self.params = StepParams(
            ba_window=ba_window, ba_max_points=ba_max_points,
            ba_iterations=ba_iterations, ba_every_kf=ba_every_kf,
            ba_fixed=ba_fixed, ba_pose_prior=ba_pose_prior,
            loop_every_kf=loop_every_kf, loop_min_gap=loop_min_gap,
            loop_min_score=loop_min_score, loop_min_inliers=loop_min_inliers,
            loop_max_rmse=loop_max_rmse, loop_consistency=loop_consistency,
            loop_max_corr_t=loop_max_corr_t, loop_max_corr_r=loop_max_corr_r,
            reloc_min_inliers=reloc_min_inliers, reloc_max_rmse=reloc_max_rmse,
            reloc_min_score=reloc_min_score, pgo_iterations=pgo_iterations,
            gba_after_loop=gba_after_loop, gba_window=gba_window,
            gba_iterations=gba_iterations, gba_sweeps=gba_sweeps,
            reassoc_mode=reassoc_mode, reassoc_gate=reassoc_gate,
        )
        self._kp_capacity = keypoint_capacity(fcfg)
        self._max_frames = max_frames
        self.reset()

    def reset(self) -> None:
        """Drop all tracking and map state and start a fresh session."""
        self.pose_buffer = PoseBuffer()
        self.state = create_slam_state(self.tcfg, self._kp_capacity, self._max_frames, self.device)
        self._frames: List[Tuple[int, float]] = []

    def feed_rgbd_frame(
        self,
        rgb: np.ndarray,  # [H, W, 3] uint8/float
        depth: np.ndarray,  # [H, W] float32 meters
        timestamp: float,
        frame_id: Optional[int] = None,
        pose_hint: Optional[SE3] = None,
    ) -> FrameInfo:
        """Track one RGB-D frame; returns its (pose, tracked, ...) feedback."""
        with TRACE.span("slam.upload"):
            rgb_t = torch.as_tensor(np.asarray(rgb)).to(self.device)
            depth_t = torch.as_tensor(np.asarray(depth, np.float32)).to(self.device)
        with TRACE.span("slam.detect"):
            kp = detect_and_describe(rgb_to_gray(rgb_t), self.fcfg)
        return self._feed(kp, depth_t, timestamp, frame_id, pose_hint)

    def feed_stereo_frame(
        self,
        left,  # [H, W, 3] or [H, W] rectified left: numpy, or a tensor on any device
        right,  # rectified right
        timestamp: float,
        frame_id: Optional[int] = None,
        pose_hint: Optional[SE3] = None,
    ) -> FrameInfo:
        """Track one rectified stereo pair: per-keypoint epipolar ZNCC
        depth feeds the RGB-D landmark path (needs `focal_x_baseline`)."""
        if self.focal_x_baseline <= 0:
            raise ValueError("stereo tracking needs focal_x_baseline > 0")
        def img(a):
            if isinstance(a, torch.Tensor):  # already on a device: cast there
                return a.to(self.device, torch.float32)
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

        with TRACE.span("slam.upload"):
            l, r = img(left), img(right)
        with TRACE.span("slam.detect"):
            gray_l = rgb_to_gray(l) if l.ndim == 3 else l
            gray_r = rgb_to_gray(r) if r.ndim == 3 else r
            kp = detect_and_describe(gray_l, self.fcfg)
        with TRACE.span("slam.stereo_depth"):
            d, ok = stereo_keypoint_depth(
                gray_l, gray_r, kp.uv, kp.valid, focal_x_baseline=self.focal_x_baseline,
                max_disparity=self.max_disparity, min_depth=self.tcfg.min_depth,
                max_depth=self.tcfg.max_depth,
            )
            depth = sparse_depth_image(kp.uv, d, ok, self.cam.height, self.cam.width)
        return self._feed(kp, depth, timestamp, frame_id, pose_hint)

    def _feed(self, kp: Keypoints, depth: torch.Tensor, timestamp: float,
              frame_id: Optional[int], pose_hint: Optional[SE3]) -> FrameInfo:
        dev = self.device
        fid = len(self._frames) if frame_id is None else frame_id
        self._frames.append((fid, timestamp))
        pose0 = SE3.identity(dev) if pose_hint is None else SE3(
            pose_hint.R.to(dev, torch.float32), pose_hint.t.to(dev, torch.float32)
        )
        with TRACE.span("slam.step"):
            self.state, info = slam_frame_step(
                self.state, kp, depth,
                torch.full((), fid, dtype=torch.int32, device=dev),
                torch.full((), timestamp, dtype=torch.float32, device=dev),
                pose0, self.cam, self.tcfg, self.params,
            )
        with TRACE.span("pose_buffer.register"):
            self.pose_buffer.register_lazy(timestamp, info.pose, info._dev["tracked"])
        return info

    def refine_map(self, mesh=None, window: int = 16, iterations: int = 6, sweeps: int = 2) -> dict:
        """Offline map-wide structure and pose refinement over the whole
        keyframe database: overlapping sliding-window BA sweeps like the
        post-loop global BA. With a shard `mesh` (`parallel.LocalMesh` or
        `ProcessGroupMesh`) each window is solved by the distributed
        Schur solver over the mesh's axis. Returns {"rmse_before",
        "rmse_after", "windows"}."""
        if mesh is not None:
            from ra_slam_tpu_torch.parallel.dist_ba import solve_window_distributed

            solve = functools.partial(solve_window_distributed, cam=self.cam, mesh=mesh,
                                      axis=list(mesh.shape.keys())[0], iterations=iterations)
        else:
            solve = functools.partial(solve_window, cam=self.cam, iterations=iterations)
        kfc = int(self.state.track.kf_counter)
        kfs, lms = self.state.kfs, self.state.track.lms
        stride = max(window // 2, 1)
        starts = list(range(0, max(kfc - window, 0) + 1, stride)) or [0]
        r0s, r1s = [], []
        for _ in range(sweeps):
            for start in starts:
                win = gather_window(kfs, lms, kfc, window, self.params.ba_max_points, start=start)
                poses, points, st = solve(win)
                kfs, lms = scatter_window(kfs, lms, win, poses, points)
                r0s.append(float(st.rmse_before))
                r1s.append(float(st.rmse_after))
        old_kf = _newest_kf(self.state)
        self.state = _propagate_kf_correction(dataclasses.replace(self.state, kfs=kfs), old_kf, kfs, lms)
        return {"rmse_before": float(np.mean(r0s)), "rmse_after": float(np.mean(r1s)), "windows": len(r0s)}

    @property
    def lost(self) -> bool:
        """True while tracking is lost (before relocalization)."""
        with TRACE.wait("slam.lost"):
            return bool(self.state.track.lost)

    @property
    def num_loop_closures(self) -> int:
        return int(self.state.n_loops)

    @property
    def num_relocalizations(self) -> int:
        return int(self.state.n_relocs)

    @property
    def edges(self) -> PoseGraphEdges:
        return self.state.edges

    def query_pose(self, timestamp: float) -> Optional[SE3]:
        """Interpolated cam_T_world at a timestamp (None before any)."""
        return self.pose_buffer.query(timestamp)

    def trajectory(self) -> List[Tuple[int, np.ndarray]]:
        """(frame_id, 3x4 cam_T_world) of every tracked frame, composed
        as cTw = cTk · kTw from each frame's reference keyframe."""
        st = self.state
        n = int(st.n_frames)
        if n > st.fs_ref.shape[0]:
            raise RuntimeError(f"fed {n} frames > max_frames={st.fs_ref.shape[0]}; raise max_frames")
        ref = st.fs_ref[:n].cpu().numpy()
        relR = st.fs_relR[:n].cpu().numpy()
        relt = st.fs_relt[:n].cpu().numpy()
        tracked = st.fs_tracked[:n].cpu().numpy()
        Rk, tk = st.kfs.R.cpu().numpy(), st.kfs.t.cpu().numpy()
        out = []
        for i in range(n):
            if tracked[i]:
                R = relR[i] @ Rk[ref[i]]
                t = relR[i] @ tk[ref[i]] + relt[i]
                out.append((self._frames[i][0], np.concatenate([R, t[:, None]], axis=1)))
        return out

    def keyframe_trajectory(self) -> List[Tuple[int, np.ndarray]]:
        """(frame_id, 3x4 cam_T_world) of the keyframes."""
        kfs = self.state.kfs
        n = int(self.state.track.kf_counter)
        fids = kfs.frame_id[:n].cpu().numpy()
        Rs, ts = kfs.R[:n].cpu().numpy(), kfs.t[:n].cpu().numpy()
        return [
            (int(fids[k]), np.concatenate([Rs[k], ts[k][:, None]], axis=1)) for k in range(n)
        ]
