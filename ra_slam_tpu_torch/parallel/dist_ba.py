"""Distributed Schur-complement bundle adjustment over a shard mesh
(counterpart of `ra_slam_tpu/parallel/dist_ba.py`).

Both sides of the normal equations are sharded:

  - observations by contiguous index slices ([N/n] per shard): a shard
    computes residuals and Jacobians only for its slice;
  - landmark rows by contiguous slices ([L/n] per shard): the point
    sheet ([L, 3]) is `all_gather`ed every iteration so that any shard
    can evaluate any observation, and the landmark-side accumulations
    (Hll, gl and the [L, W, 6, 3] coupling tensor U) return to their
    owner shard through one `psum_scatter` each, so the 3x3 block
    elimination stays sharded;
  - the shards' parts of the reduced camera system add up exactly:
    `S = psum(S_part)`, `rhs = psum(rhs_part)`; the [6W, 6W] solve is
    replicated and the landmark back-substitution local.

The body uses `slam/ba.py`'s assembly helpers, so that each iteration
is `_gn_step` with the collectives between its stages, and it runs the
same two-phase chi2 prune and pose prior as `solve_window`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.se3 import SE3, exp_se3
from ra_slam_tpu_torch.slam.ba import (
    BAStats,
    BAWindow,
    _landmark_blocks,
    _landmark_inverse,
    _landmark_step,
    _linearize,
    _pose_blocks,
    _pose_step,
    _reduced_system,
    _residuals,
    _weighted_rmse,
    gather_window,
    scatter_window,
)
from ra_slam_tpu_torch.slam.keyframes import Keyframes
from ra_slam_tpu_torch.slam.landmarks import Landmarks

_OBS_FIELDS = ("obs_k", "obs_l", "obs_uv", "obs_w", "obs_z")


def _solve_shard(ctx, points_l, point_ok_l, win_l: BAWindow, cam: PinholeCamera, iterations: int,
                 huber_delta: float, damping: float, chi2_prune: float, pose_prior: float):
    """Shard body: Gauss-Newton with the reduced camera system summed
    over the shards. `win_l` holds the replicated pose-side fields and
    this shard's observation slice; points_l / point_ok_l its landmark
    rows. Returns (poses, all points [L, 3], rmse)."""
    W = win_l.kf_free.shape[0]
    L = points_l.shape[0] * ctx.size
    k, l = win_l.obs_k.long(), win_l.obs_l.long()

    def iteration(poses: SE3, points_l, obs_w):
        # the point sheet is tiny next to the coupling tensor: gather it
        # whole, evaluate only the local observation slice against it
        points = ctx.all_gather(points_l)
        r, J_p_f, Jw_p, J_x, Jw_x = _linearize(poses, points, obs_w, win_l, cam, huber_delta)
        Hpp, gp = _pose_blocks(W, k, r, J_p_f, Jw_p)
        # landmark-side partials over the whole sheet; one reduce-scatter
        # each returns every row to its owner shard
        Hll_f, gl_f, U_f = _landmark_blocks(L, W, k, l, r, Jw_p, J_x, Jw_x)
        Hll, gl, U = (ctx.psum_scatter(x) for x in (Hll_f, gl_f, U_f))
        Hinv, occupied = _landmark_inverse(Hll, point_ok_l, damping)
        S_part, rhs_part = _reduced_system(Hpp, gp, U, Hinv, gl)
        dxi = _pose_step(ctx.psum(S_part), ctx.psum(rhs_part), poses, win_l, damping, pose_prior)
        return exp_se3(dxi) @ poses, points_l + _landmark_step(U, Hinv, gl, dxi, occupied)

    n1 = max(iterations // 2, 1)
    poses, points_l = win_l.poses, points_l
    for _ in range(n1):
        poses, points_l = iteration(poses, points_l, win_l.obs_w)
    # chi2 outlier removal between the phases (as solve_window)
    rp, _, _, okp = _residuals(poses, ctx.all_gather(points_l), win_l, cam)
    obs_w2 = torch.where(okp & (torch.sum(rp * rp, -1) <= chi2_prune), win_l.obs_w, 0.0)
    for _ in range(max(iterations - n1, 0)):
        poses, points_l = iteration(poses, points_l, obs_w2)

    # weighted rmse over the observation slices
    points = ctx.all_gather(points_l)
    r1, _, _, ok1 = _residuals(poses, points, win_l, cam)
    live = (obs_w2 * ok1) > 0
    sum_r2 = ctx.psum(torch.sum(torch.where(live, torch.sum(r1 * r1, -1), 0.0)))
    cnt = ctx.psum(torch.sum(live.to(torch.float32)))
    return poses, points, torch.sqrt(sum_r2 / torch.clamp(cnt, min=1.0))


def _slices(x: torch.Tensor, mesh) -> list:
    """This process's shards of `x`: contiguous dim-0 slices."""
    c = x.shape[0] // mesh.size
    return [x[i * c:(i + 1) * c] for i in mesh.local_shards]


def solve_window_distributed(
    win: BAWindow,
    cam: PinholeCamera,
    mesh,
    axis: str = "ba",
    iterations: int = 8,
    huber_delta: float = 3.0,
    damping: float = 1e-4,
    chi2_prune: float = 36.0,
    pose_prior: float = 2e3,
) -> Tuple[SE3, torch.Tensor, BAStats]:
    """Distributed solve of a gathered window over `mesh` (whose axis is
    `axis`); the landmark capacity L and the observation capacity N must
    divide by the mesh size (gather_window's capacities are powers of
    two). Every process gets the whole result."""
    L = win.points.shape[0]
    N = win.obs_k.shape[0]
    n = mesh.shape[axis]
    assert L % n == 0, f"max_points {L} must be divisible by mesh size {n}"
    assert N % n == 0, f"obs capacity {N} must be divisible by mesh size {n}"

    r0, _, _, ok0 = _residuals(win.poses, win.points, win, cam)
    rmse0 = _weighted_rmse(r0, win.obs_w * ok0)

    obs = {f: _slices(getattr(win, f), mesh) for f in _OBS_FIELDS}
    wins = [dataclasses.replace(win, **{f: obs[f][j] for f in _OBS_FIELDS})
            for j in range(len(mesh.local_shards))]
    body = functools.partial(
        _solve_shard, cam=cam, iterations=iterations, huber_delta=huber_delta,
        damping=damping, chi2_prune=chi2_prune, pose_prior=pose_prior,
    )
    # poses, points and rmse are the same on every shard
    poses, points, rmse1 = mesh.run(body, _slices(win.points, mesh), _slices(win.point_ok, mesh), wins)[0]
    stats = BAStats(
        num_poses=win.kf_free.sum(dtype=torch.int32),
        num_points=win.point_ok.sum(dtype=torch.int32),
        num_obs=(win.obs_w > 0).sum(dtype=torch.int32),
        rmse_before=rmse0,
        rmse_after=rmse1,
        points_dropped=win.points_dropped,
    )
    return poses, points, stats


def distributed_bundle_adjustment(
    kfs: Keyframes,
    lms: Landmarks,
    kf_counter,
    cam: PinholeCamera,
    mesh,
    axis: str = "ba",
    window: int = 8,
    max_points: int = 4096,
    iterations: int = 8,
    huber_delta: float = 3.0,
    pose_prior: float = 2e3,
) -> Tuple[Keyframes, Landmarks, BAStats]:
    """gather -> distributed Schur solve -> scatter."""
    win = gather_window(kfs, lms, kf_counter, window, max_points)
    poses, points, stats = solve_window_distributed(
        win, cam, mesh, axis=axis, iterations=iterations, huber_delta=huber_delta, pose_prior=pose_prior,
    )
    kfs, lms = scatter_window(kfs, lms, win, poses, points)
    return kfs, lms, stats
