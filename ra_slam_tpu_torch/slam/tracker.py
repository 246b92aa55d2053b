"""Frame-to-map RGB-D tracking (counterpart of `ra_slam_tpu/slam/tracker.py`).

Constant-velocity pose prediction, projective descriptor matching of the
frame's features against every landmark (one dense Hamming matrix,
`ops/hamming.py`, gated by projected pixel distance), two-stage
motion-only Gauss-Newton, acceptance gates and the keyframe policy. All
of it stays on the device: decisions come back as boolean tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera, bilinear_sample, nearest_sample
from ra_slam_tpu_torch.core.config import TrackingConfig
from ra_slam_tpu_torch.core.se3 import SE3, exp_se3, log_se3, where_pose
from ra_slam_tpu_torch.features.matching import best_two, hamming_matrix
from ra_slam_tpu_torch.features.orb import NUM_PAIRS, Keypoints
from ra_slam_tpu_torch.slam.landmarks import (
    Landmarks,
    add_landmarks,
    create_landmarks,
    cull_landmarks,
    record_observations,
    scatter_rows,
)
from ra_slam_tpu_torch.slam.pnp import motion_only_gn
from ra_slam_tpu_torch.utils.profiling import TRACE

_INF = float("inf")


@dataclass(frozen=True)
class TrackState:
    """Tracker state threaded through frames (scalars are 0-dim tensors)."""

    pose: SE3  # cam_T_world of the last tracked frame
    velocity: torch.Tensor  # [6] twist: pose_k ~ exp(velocity) @ pose_{k-1}
    lms: Landmarks
    kf_counter: torch.Tensor  # int32 number of keyframes so far
    frames_since_kf: torch.Tensor  # int32
    last_kf_pose: SE3
    initialized: torch.Tensor  # bool
    lost: torch.Tensor  # bool
    bad_streak: torch.Tensor  # int32 consecutive soft gate failures


def create_track_state(max_landmarks: int, device) -> TrackState:
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    b = lambda v: torch.tensor(v, dtype=torch.bool, device=device)
    return TrackState(
        pose=SE3.identity(device),
        velocity=torch.zeros(6, dtype=torch.float32, device=device),
        lms=create_landmarks(max_landmarks, device),
        kf_counter=i32(0),
        frames_since_kf=i32(0),
        last_kf_pose=SE3.identity(device),
        initialized=b(False),
        lost=b(False),
        bad_streak=i32(0),
    )


def keypoint_depth(
    depth: torch.Tensor, kp: Keypoints, tcfg: TrackingConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-aware per-keypoint depth: bilinear where the 2x2 neighbourhood
    is depth-continuous, nearest at discontinuities. Returns (d [F],
    valid [F])."""
    d_near, dvalid = nearest_sample(depth, kp.uv)
    d_bil, bvalid = bilinear_sample(depth, kp.uv)
    smooth = bvalid & ((d_bil - d_near).abs() < 0.05 * torch.clamp(d_near, min=0.1))
    d = torch.where(smooth, d_bil, d_near)
    return d, dvalid & (d > tcfg.min_depth) & (d < tcfg.max_depth)


def _pixel_d2(uv: torch.Tensor, uv_lm: torch.Tensor) -> torch.Tensor:
    """[F, M] squared pixel distance between features and projections."""
    du = uv[:, None, 0] - uv_lm[None, :, 0]
    dv = uv[:, None, 1] - uv_lm[None, :, 1]
    return du * du + dv * dv


def _gated_match(
    dist: torch.Tensor,  # [F, M] Hamming distances
    kp: Keypoints,
    lms: Landmarks,
    pose: SE3,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    radius: float,
    kf_counter: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projective gate at `pose`/`radius` over a precomputed Hamming
    matrix, then best match with a ratio test."""
    uv_lm, z = cam.project(pose.apply(lms.pos))
    proj_ok = lms.valid & (z > 0.05) & cam.in_bounds(uv_lm)
    if tcfg.track_max_age > 0 and kf_counter is not None:
        # local-map gate: only recently seen landmarks are candidates
        proj_ok = proj_ok & (kf_counter - lms.last_seen <= tcfg.track_max_age)
    gate = proj_ok[None, :] & (_pixel_d2(kp.uv, uv_lm) <= float(radius) ** 2)
    best, bidx, second = best_two(torch.where(gate, dist, _INF))
    ok = (
        kp.valid
        & torch.isfinite(best)
        & (best <= tcfg.match_hamming_max)
        & (best < tcfg.match_ratio * torch.clamp(second, max=float(NUM_PAIRS)))
    )
    return torch.where(ok, bidx, -1).to(torch.int32), ok


def match_frame_to_map(
    kp: Keypoints,
    lms: Landmarks,
    pose_pred: SE3,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    kf_counter: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projective-gated dense matching: (lm_idx [F] int32, -1 = none;
    valid [F] bool)."""
    dist = hamming_matrix(kp.desc, lms.desc)
    return _gated_match(dist, kp, lms, pose_pred, cam, tcfg, tcfg.match_radius, kf_counter)


@dataclass(frozen=True)
class TrackResult:
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    rmse: torch.Tensor
    need_keyframe: torch.Tensor
    lm_idx: torch.Tensor  # [F] matched landmark per feature (-1 none)
    inlier: torch.Tensor  # [F] bool
    jump_t: torch.Tensor  # refined pose's deviation from the prediction (m)
    jump_r: torch.Tensor  # (rad)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x)


def track_frame(
    state: TrackState,
    kp: Keypoints,
    depth: torch.Tensor,  # [H, W] float32 meters (0 = invalid)
    cam: PinholeCamera,
    tcfg: TrackingConfig,
) -> Tuple[TrackState, TrackResult]:
    """Track one frame against the landmark map, in two stages: match in
    a wide gate at the motion-model pose and optimise, then re-match in
    a tight gate at the refined pose and optimise again with the
    per-keypoint depth residual. Both stages use one Hamming matrix."""
    pose_pred = exp_se3(state.velocity) @ state.pose
    d_kp, has_depth = keypoint_depth(depth, kp, tcfg)
    d_obs = torch.where(has_depth, d_kp, 0.0)

    with TRACE.span("track.match"):
        dist = hamming_matrix(kp.desc, state.lms.desc)  # [F, M]
        lm_idx1, mvalid1 = _gated_match(
            dist, kp, state.lms, pose_pred, cam, tcfg, tcfg.match_radius, state.kf_counter
        )
    with TRACE.span("track.gn"):
        res1 = motion_only_gn(
            pose_pred, state.lms.pos[torch.clamp(lm_idx1, min=0).long()], kp.uv,
            mvalid1.to(torch.float32), cam,
            iterations=tcfg.gn_iterations, huber_delta=tcfg.huber_delta,
        )

    with TRACE.span("track.match"):
        lm_idx, mvalid = _gated_match(
            dist, kp, state.lms, res1.pose, cam, tcfg, tcfg.rematch_radius, state.kf_counter
        )
        pts = state.lms.pos[torch.clamp(lm_idx, min=0).long()]
        n_match = mvalid.sum(dtype=torch.int32)
    with TRACE.span("track.gn"):
        res = motion_only_gn(
            res1.pose, pts, kp.uv, mvalid.to(torch.float32), cam,
            iterations=tcfg.gn_iterations, huber_delta=tcfg.huber_delta,
            depth_obs=d_obs, depth_weight=tcfg.track_depth_weight,
        )

    # acceptance gates: hard failure = inlier collapse; soft failure =
    # residual size / implausible single-frame jump
    jump = log_se3(res.pose @ pose_pred.inverse())
    jump_t, jump_r = _norm(jump[3:]), _norm(jump[:3])
    collapsed = (res.num_inliers < tcfg.min_inliers) | (
        res.num_inliers.to(torch.float32)
        < tcfg.min_inlier_ratio * torch.clamp(n_match, min=1).to(torch.float32)
    )
    soft_bad = (
        (res.rmse > tcfg.max_track_rmse)
        | (jump_t > tcfg.max_pose_jump_t)
        | (jump_r > tcfg.max_pose_jump_r)
    )
    ok = ~collapsed & ~soft_bad
    streak = torch.where(ok, 0, state.bad_streak + 1).to(torch.int32)
    lost = state.initialized & (collapsed | (streak >= tcfg.reloc_after))

    pose_new = where_pose(ok, res.pose, pose_pred)
    # soft-bad keeps the velocity, hard loss zeroes it
    vel_new = torch.where(
        ok,
        log_se3(pose_new @ state.pose.inverse()),
        torch.where(lost, torch.zeros_like(state.velocity), state.velocity),
    )

    inlier = res.inliers & mvalid
    lms = record_observations(state.lms, lm_idx, inlier & ok, state.kf_counter)

    # keyframe policy: min interval + motion or weak tracking
    xi = log_se3(pose_new @ state.last_kf_pose.inverse())
    moved = (
        (_norm(xi[3:]) > tcfg.keyframe_translation)
        | (_norm(xi[:3]) > tcfg.keyframe_rotation)
        | (res.num_inliers < tcfg.keyframe_min_inliers)
    )
    need_kf = state.initialized & ok & (state.frames_since_kf >= tcfg.keyframe_min_interval) & moved

    new_state = dataclasses.replace(
        state,
        pose=pose_new,
        velocity=vel_new,
        lms=lms,
        frames_since_kf=state.frames_since_kf + 1,
        lost=lost,
        bad_streak=streak,
    )
    return new_state, TrackResult(
        num_matches=n_match,
        num_inliers=res.num_inliers,
        rmse=res.rmse,
        need_keyframe=need_kf,
        lm_idx=lm_idx,
        inlier=inlier,
        jump_t=jump_t,
        jump_r=jump_r,
    )


def insert_keyframe_landmarks(
    state: TrackState,
    kp: Keypoints,
    depth: torch.Tensor,  # [H, W] float32 meters (0 = invalid)
    lm_idx: torch.Tensor,  # [F] from TrackResult (-1 = unmatched)
    cam: PinholeCamera,
    tcfg: TrackingConfig,
) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Keyframe insertion: unmatched features re-bind to an existing
    landmark that agrees in descriptor, pixel and depth (fusion), or
    else, with valid depth and no landmark nearby, become new landmarks.
    Returns (new state, per-feature landmark index [F] (-1 = none),
    per-feature measured depth [F] (0 = none))."""
    d, has_depth = keypoint_depth(depth, kp, tcfg)
    lms = state.lms

    uv_lm, z_lm = cam.project(state.pose.apply(lms.pos))
    hd = hamming_matrix(kp.desc, lms.desc)  # [F, M]
    d2 = _pixel_d2(kp.uv, uv_lm)
    depth_ok = (z_lm[None, :] - d[:, None]).abs() <= tcfg.fuse_depth_ratio * d[:, None] + 0.05
    gate = (
        lms.valid[None, :]
        & (z_lm[None, :] > 0.05)
        & (d2 <= float(tcfg.fuse_radius) ** 2)
        & depth_ok
    )
    hd = torch.where(gate, hd, _INF)
    fuse_best = torch.argmin(hd, dim=1).to(torch.int32)
    fuse_ok = has_depth & kp.valid & (hd.amin(dim=1) <= tcfg.fuse_hamming_max)
    eff_idx = torch.where(lm_idx >= 0, lm_idx, torch.where(fuse_ok, fuse_best, -1))

    # spawn suppression: no new landmark where any gated landmark lies
    # within the suppression radius
    occupied = (gate & (d2 <= float(tcfg.spawn_suppress_radius) ** 2)).any(dim=1)
    new_mask = kp.valid & (eff_idx < 0) & has_depth & ~occupied
    p_world = state.pose.inverse().apply(cam.unproject(kp.uv, d))

    lms, new_ids = add_landmarks(lms, p_world, kp.desc, new_mask, state.kf_counter)
    seen = (eff_idx >= 0) & kp.valid
    lms = record_observations(lms, eff_idx, seen, state.kf_counter)
    # re-observed landmarks adopt this keyframe's descriptor
    lms = dataclasses.replace(lms, desc=scatter_rows(lms.desc, eff_idx, kp.desc, seen))
    lms = cull_landmarks(lms, state.kf_counter, min_obs=tcfg.cull_min_obs, max_age=tcfg.cull_max_age)
    obs_lm = torch.where(eff_idx >= 0, eff_idx, new_ids)

    new_state = dataclasses.replace(
        state,
        lms=lms,
        kf_counter=state.kf_counter + 1,
        frames_since_kf=torch.zeros_like(state.frames_since_kf),
        last_kf_pose=state.pose,
        initialized=torch.ones_like(state.initialized),
    )
    obs_z = torch.where(has_depth & kp.valid, d, 0.0)
    return new_state, obs_lm, obs_z


def initialize_from_frame(
    state: TrackState,
    kp: Keypoints,
    depth: torch.Tensor,
    cam: PinholeCamera,
    pose: SE3,
    tcfg: TrackingConfig,
) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Bootstrap the map from the first frame at a known (or identity)
    pose: every valid-depth keypoint becomes a landmark."""
    state = dataclasses.replace(state, pose=pose, last_kf_pose=pose)
    lm_idx = torch.full((kp.capacity,), -1, dtype=torch.int32, device=kp.uv.device)
    return insert_keyframe_landmarks(state, kp, depth, lm_idx, cam, tcfg)
