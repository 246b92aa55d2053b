"""Windowed bundle adjustment: batched Gauss-Newton with the Schur
complement (counterpart of `ra_slam_tpu/slam/ba.py`).

A window of keyframes and the landmarks they observe is gathered into
fixed-shape tensors (`gather_window`); every observation's residual and
Jacobians come from one batched pass (`_residuals`); the landmark 3x3
blocks are inverted in batch, the pose-landmark coupling blocks are
scattered into a dense `[L, W, 6, 3]` tensor `U`, and the reduced camera
system `S = H_pp - U^T H_ll^-1 U` is one matrix product over (landmark,
coordinate). `S` is `[6W, 6W]` and solved densely; the landmark updates
come from back-substitution.

The JAX package's `segment_sum` becomes `index_add_` and `.at[].add`
becomes `index_put_(accumulate=True)`: on CUDA both sum in an order that
can change between runs, so two solves of one window agree to rounding,
not bit for bit. Nothing here reads a device value on the host except
`global_bundle_adjustment`'s chunk count (pass a Python int as
`kf_counter` to keep that read with the caller).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.se3 import SE3, exp_se3, log_se3
from ra_slam_tpu_torch.slam.keyframes import Keyframes
from ra_slam_tpu_torch.slam.landmarks import Landmarks, scatter_rows

_FIX_PRIOR = 1e8  # diagonal prior that pins a pose (g2o set_fixed analog)
_INT_MAX = 2**31 - 1
_DEPTH_SIGMA = 0.01  # relative depth noise: sigma_z = _DEPTH_SIGMA * z


@dataclass(frozen=True)
class BAWindow:
    """Fixed-shape view of one BA problem."""

    kf_slot: torch.Tensor  # [W] int32 keyframe slot per window row
    kf_free: torch.Tensor  # [W] bool pose is optimised (False = fixed/pad)
    poses: SE3  # [W] cam_T_world
    loc2glob: torch.Tensor  # [L] int32 global landmark id (INT_MAX = unused)
    points: torch.Tensor  # [L, 3] world positions
    point_ok: torch.Tensor  # [L] bool slot holds a real landmark
    obs_k: torch.Tensor  # [N] int32 window row of each observation
    obs_l: torch.Tensor  # [N] int32 local landmark index
    obs_uv: torch.Tensor  # [N, 2] float32
    obs_w: torch.Tensor  # [N] float32 (0 = invalid)
    obs_z: torch.Tensor  # [N] float32 measured depth (0 = none)
    # unique window landmarks that did not fit max_points: their
    # observations are dropped and their positions stay as they were
    points_dropped: torch.Tensor  # int32


@dataclass(frozen=True)
class BAStats:
    num_poses: torch.Tensor
    num_points: torch.Tensor
    num_obs: torch.Tensor
    rmse_before: torch.Tensor
    rmse_after: torch.Tensor
    points_dropped: torch.Tensor  # unique landmarks beyond max_points


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def gather_window(
    kfs: Keyframes,
    lms: Landmarks,
    kf_counter,
    window: int,
    max_points: int,
    start=None,
    n_fixed: int = 0,
) -> BAWindow:
    """A window of `window` keyframes and their landmarks, fixed shapes.

    Keyframe slots are insertion-ordered, so a window is a contiguous
    slot range: by default the newest `window` keyframes (local BA),
    with `n_fixed` older keyframes prepended as pose-fixed rows that
    still contribute their observations; with `start` the range from
    there (global-BA chunks), its oldest row fixed. The local landmark
    set is the sorted unique ids the rows observe; past `max_points`
    the newest (highest ids) are kept and the rest counted in
    `points_dropped`."""
    dev = kfs.R.device
    W, L = window + n_fixed, max_points
    F = kfs.num_features
    kfc = _i32(kf_counter, dev)
    if start is None:
        free_start = torch.clamp(kfc - window, min=0)
        start = torch.clamp(free_start - n_fixed, min=0)
    else:
        start = _i32(start, dev)
        free_start = start + 1  # GBA chunk: the oldest row anchors
    slot = start + torch.arange(W, dtype=torch.int32, device=dev)
    kf_ok = slot < kfc
    slot_c = torch.clamp(slot, max=kfs.capacity - 1)
    sl = slot_c.long()

    poses = SE3(kfs.R[sl], kfs.t[sl])
    # fixed observers and keyframe 0 anchor the gauge; padding never free
    kf_free = kf_ok & (slot >= free_start) & (slot > 0)

    # local landmark set: sorted unique ids observed by the window
    obs_gid = torch.where(kf_ok[:, None], kfs.obs_lm[sl], -1).reshape(-1)  # [W*F]
    w_obs = torch.where(kf_ok[:, None], kfs.obs_w[sl], 0.0).reshape(-1)
    gid = torch.where((obs_gid >= 0) & (w_obs > 0), obs_gid, _INT_MAX)
    sorted_gid = torch.sort(gid).values
    is_first = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev), sorted_gid[1:] != sorted_gid[:-1]
    ]) & (sorted_gid < _INT_MAX)
    rank = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_unique = is_first.sum(dtype=torch.int32)
    # over capacity: keep the newest L landmarks (the highest ids)
    shift = torch.clamp(n_unique - L, min=0)
    rank = rank - shift
    dest = torch.where(is_first & (rank >= 0) & (rank < L), rank, L).long()
    ext = torch.full((L + 1,), _INT_MAX, dtype=torch.int32, device=dev)
    loc2glob = ext.index_put_((dest,), sorted_gid)[:L]  # dest is unique below L
    point_ok = loc2glob < _INT_MAX

    glob_c = torch.clamp(loc2glob, max=lms.capacity - 1).long()
    points = lms.pos[glob_c]
    point_ok = point_ok & lms.valid[glob_c]

    # flat observations with local landmark indices (binary search)
    obs_l = torch.searchsorted(loc2glob, torch.clamp(obs_gid, min=0), out_int32=True)
    obs_l = torch.clamp(obs_l, max=L - 1)
    hit = (obs_gid >= 0) & (loc2glob[obs_l.long()] == obs_gid) & point_ok[obs_l.long()]
    obs_k = torch.arange(W, dtype=torch.int32, device=dev).repeat_interleave(F)
    return BAWindow(
        kf_slot=slot_c,
        kf_free=kf_free,
        poses=poses,
        loc2glob=loc2glob,
        points=points,
        point_ok=point_ok,
        obs_k=obs_k,
        obs_l=obs_l,
        obs_uv=kfs.obs_uv[sl].reshape(-1, 2),
        obs_w=torch.where(hit, w_obs, 0.0),
        obs_z=kfs.obs_z[sl].reshape(-1),
        points_dropped=shift,
    )


def _robust_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(r <= delta, 1.0, delta / r)


def clamp_twist(dxi: torch.Tensor, max_r: float = 0.5, max_t: float = 0.5) -> torch.Tensor:
    """Trust-region clamp of [..., 6] twists [w, v]: the solvers run
    fixed-damping GN, so a near-singular window would otherwise take an
    unbounded step."""
    r, t = dxi[..., :3], dxi[..., 3:]
    rn = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    tn = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    r = r * torch.clamp(max_r / torch.clamp(rn, min=1e-9), max=1.0)
    t = t * torch.clamp(max_t / torch.clamp(tn, min=1e-9), max=1.0)
    return torch.cat([r, t], dim=-1)


def _residuals(poses: SE3, points: torch.Tensor, win: BAWindow, cam: PinholeCamera):
    """RGB-D residual rows [r_u, r_v, r_d] of every observation: the 2D
    reprojection (px) and the measured-depth residual scaled to a
    pixel-comparable sigma, `r_d = (z_pred - z_meas) / (_DEPTH_SIGMA *
    z_meas)`, zero where the observation has no depth.

    Returns r [N, 3], J_p [N, 3, 6] (wrt the left-multiplied pose
    twist), J_x [N, 3, 3] (wrt the world point), ok [N]."""
    k, l = win.obs_k.long(), win.obs_l.long()
    pose_n = SE3(poses.R[k], poses.t[k])
    p = pose_n.apply(points[l])  # [N, 3] camera frame
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ok = z > 1e-6
    zs = torch.where(ok, z, 1.0)
    inv_z = 1.0 / zs
    u = x * inv_z * cam.fx + cam.cx
    v = y * inv_z * cam.fy + cam.cy
    has_zb = win.obs_z > 1e-6
    zm = torch.where(has_zb, win.obs_z, 1.0)
    dscale = has_zb.to(p.dtype) / (_DEPTH_SIGMA * zm)
    r = torch.stack([u - win.obs_uv[..., 0], v - win.obs_uv[..., 1], (zs - zm) * dscale], dim=-1)

    fx, fy = cam.fx, cam.fy
    zero = torch.zeros_like(x)
    J_proj = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], -1),
        torch.stack([zero, zero, dscale], -1),
    ], -2)  # [N, 3, 3] d(residual)/d(p_cam)
    # dp/dxi for a left-multiplied exp(xi) T: dp = -[p]x w + v
    px = torch.stack([
        torch.stack([zero, z, -y], -1),
        torch.stack([-z, zero, x], -1),
        torch.stack([y, -x, zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(px.shape)
    J_pxi = torch.cat([px, eye], dim=-1)  # [N, 3, 6]
    return r, torch.matmul(J_proj, J_pxi), torch.matmul(J_proj, pose_n.R), ok


def _weighted_rmse(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    r2 = torch.sum(r * r, -1)
    n = torch.clamp(torch.sum((w > 0).to(r2.dtype)), min=1.0)
    return torch.sqrt(torch.sum(torch.where(w > 0, r2, 0.0)) / n)


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """[W, 6, 6] blocks -> [W, 6, W, 6] with them on the diagonal."""
    W = blocks.shape[0]
    return torch.einsum("kab,kj->kajb", blocks, torch.eye(W, dtype=blocks.dtype, device=blocks.device))


def _linearize(poses: SE3, points: torch.Tensor, obs_w: torch.Tensor, win: BAWindow, cam,
               huber_delta: float):
    """Residuals and robust-weighted Jacobians of the window's
    observations: (r, J_p_f, Jw_p, J_x, Jw_x), the pose Jacobian of
    fixed rows zeroed so that their update is exactly 0."""
    r, J_p, J_x, ok = _residuals(poses, points, win, cam)
    w = obs_w * ok * _robust_weight(torch.sum(r * r, -1), huber_delta)  # [N]
    J_p_f = J_p * win.kf_free[win.obs_k.long()][:, None, None]
    return r, J_p_f, J_p_f * w[:, None, None], J_x, J_x * w[:, None, None]


def _pose_blocks(W: int, k: torch.Tensor, r, J_p_f, Jw_p):
    """Block-diagonal pose Hessian [W, 6, 6] and gradient [W, 6]."""
    z = lambda *s: torch.zeros(s, dtype=r.dtype, device=r.device)
    Hpp = z(W, 6, 6).index_add_(0, k, torch.einsum("nri,nrj->nij", Jw_p, J_p_f))
    gp = z(W, 6).index_add_(0, k, torch.einsum("nri,nr->ni", Jw_p, r))
    return Hpp, gp


def _landmark_blocks(L: int, W: int, k: torch.Tensor, l: torch.Tensor, r, Jw_p, J_x, Jw_x):
    """Landmark Hessian blocks [L, 3, 3], gradient [L, 3] and the dense
    pose-landmark coupling U [L, W, 6, 3] (U[l, k] = H_pl^T)."""
    z = lambda *s: torch.zeros(s, dtype=r.dtype, device=r.device)
    Hll = z(L, 3, 3).index_add_(0, l, torch.einsum("nri,nrj->nij", Jw_x, J_x))
    gl = z(L, 3).index_add_(0, l, torch.einsum("nri,nr->ni", Jw_x, r))
    A = torch.einsum("nri,nrj->nij", Jw_p, J_x)  # [N, 6, 3]
    U = z(L, W, 6, 3).index_put_((l, k), A, accumulate=True)
    return Hll, gl, U


def _landmark_inverse(Hll: torch.Tensor, point_ok: torch.Tensor, damping: float):
    """Damped landmark-block inverses (Levenberg diagonal), 0 for empty
    slots, and the mask of occupied slots."""
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hll_d = Hll + (damping + 1e-8) * eye3 + damping * Hll * eye3
    occupied = point_ok & (torch.einsum("lii->l", Hll) > 1e-12)
    Hinv = torch.linalg.inv_ex(torch.where(occupied[:, None, None], Hll_d, eye3)).inverse
    return torch.where(occupied[:, None, None], Hinv, 0.0), occupied


def _reduced_system(Hpp, gp, U, Hinv, gl):
    """The landmarks' share of the reduced camera system: S = Hpp - U^T
    Hinv U [W, 6, W, 6] and rhs = gp - U^T Hinv gl [W, 6], contracted
    through Hinv U first (never an [L, W, W, 6, 6] intermediate): one
    [6W, 3L] x [3L, 6W] product. Over landmark and observation shards
    the parts add up to the whole."""
    L, W = U.shape[0], U.shape[1]
    HU = torch.einsum("lbc,ljdc->lbjd", Hinv, U)  # [L, 3, W, 6]
    S_off = (U.permute(0, 3, 1, 2).reshape(L * 3, W * 6).T @ HU.reshape(L * 3, W * 6)).reshape(W, 6, W, 6)
    Hg = torch.einsum("lbc,lc->lb", Hinv, gl)
    return -S_off + _block_diag(Hpp), gp - torch.einsum("lkab,lb->ka", U, Hg)


def _pose_step(S, rhs, poses: SE3, win: BAWindow, damping: float, pose_prior: float) -> torch.Tensor:
    """Solve the reduced system for the pose twists [W, 6], with the
    gauge/padding prior, LM damping on the pose blocks and a weak
    absolute prior toward each free pose's pre-BA estimate."""
    W = win.kf_free.shape[0]
    prior = torch.where(win.kf_free, damping + pose_prior, _FIX_PRIOR)
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    S = S + _block_diag(prior[:, None, None] * eye6)
    # prior residual: the deviation from the pre-BA pose so far
    dev = log_se3(poses @ win.poses.inverse())  # [W, 6]
    rhs = rhs + pose_prior * dev * win.kf_free[:, None]
    dxi = -torch.linalg.solve_ex(S.reshape(W * 6, W * 6), rhs.reshape(W * 6, 1)).result.reshape(W, 6)
    dxi = torch.where(torch.isfinite(dxi).all(), dxi, 0.0)
    return clamp_twist(dxi) * win.kf_free[:, None]


def _landmark_step(U, Hinv, gl, dxi, occupied) -> torch.Tensor:
    """Back-substitution dl = -Hinv (gl + U dxi), clamped to 0.5 m."""
    Ud = torch.einsum("lkab,ka->lb", U, dxi)
    dx = -torch.einsum("lab,lb->la", Hinv, gl + Ud)
    dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
    dxn = torch.linalg.vector_norm(dx, dim=-1, keepdim=True)
    dx = dx * torch.clamp(0.5 / torch.clamp(dxn, min=1e-9), max=1.0)
    return dx * occupied[:, None]


def _gn_step(poses: SE3, points: torch.Tensor, obs_w: torch.Tensor, win: BAWindow, cam,
             huber_delta: float, damping: float, pose_prior: float) -> Tuple[SE3, torch.Tensor]:
    """One damped Schur-complement Gauss-Newton step of the window."""
    W, L = win.kf_free.shape[0], win.points.shape[0]
    k, l = win.obs_k.long(), win.obs_l.long()
    r, J_p_f, Jw_p, J_x, Jw_x = _linearize(poses, points, obs_w, win, cam, huber_delta)
    Hpp, gp = _pose_blocks(W, k, r, J_p_f, Jw_p)
    Hll, gl, U = _landmark_blocks(L, W, k, l, r, Jw_p, J_x, Jw_x)
    Hinv, occupied = _landmark_inverse(Hll, win.point_ok, damping)
    S, rhs = _reduced_system(Hpp, gp, U, Hinv, gl)
    dxi = _pose_step(S, rhs, poses, win, damping, pose_prior)
    return exp_se3(dxi) @ poses, points + _landmark_step(U, Hinv, gl, dxi, occupied)


def solve_window(
    win: BAWindow,
    cam: PinholeCamera,
    iterations: int = 8,
    huber_delta: float = 3.0,
    damping: float = 1e-4,
    chi2_prune: float = 36.0,  # px^2; observations beyond are removed
    pose_prior: float = 2e3,  # odometry prior toward the pre-BA pose
) -> Tuple[SE3, torch.Tensor, BAStats]:
    """Schur-complement GN on a gathered window, in two phases: after
    the first half of the iterations every observation whose squared
    residual exceeds `chi2_prune` leaves the problem for the second half
    (Huber only down-weights a wrong association).

    Returns (optimised poses [W], optimised points [L, 3], stats)."""
    step = lambda P, X, w: _gn_step(P, X, w, win, cam, huber_delta, damping, pose_prior)
    r0, _, _, ok0 = _residuals(win.poses, win.points, win, cam)
    rmse0 = _weighted_rmse(r0, win.obs_w * ok0)

    n1 = max(iterations // 2, 1)
    poses, points = win.poses, win.points
    for _ in range(n1):
        poses, points = step(poses, points, win.obs_w)
    # chi2 outlier removal between the phases
    rp, _, _, okp = _residuals(poses, points, win, cam)
    obs_w2 = torch.where(okp & (torch.sum(rp * rp, -1) <= chi2_prune), win.obs_w, 0.0)
    for _ in range(max(iterations - n1, 0)):
        poses, points = step(poses, points, obs_w2)

    r1, _, _, ok1 = _residuals(poses, points, win, cam)
    stats = BAStats(
        num_poses=win.kf_free.sum(dtype=torch.int32),
        num_points=win.point_ok.sum(dtype=torch.int32),
        num_obs=(win.obs_w > 0).sum(dtype=torch.int32),
        rmse_before=rmse0,
        rmse_after=_weighted_rmse(r1, obs_w2 * ok1),
        points_dropped=win.points_dropped,
    )
    return poses, points, stats


def scatter_window(
    kfs: Keyframes, lms: Landmarks, win: BAWindow, poses: SE3, points: torch.Tensor
) -> Tuple[Keyframes, Landmarks]:
    """Write optimised poses and points back into the databases (rows of
    a repeated slot: the last write wins, as in the JAX package)."""
    every = torch.ones_like(win.kf_free)
    kfs = dataclasses.replace(
        kfs,
        R=scatter_rows(kfs.R, win.kf_slot, poses.R, every),
        t=scatter_rows(kfs.t, win.kf_slot, poses.t, every),
    )
    lms = dataclasses.replace(lms, pos=scatter_rows(lms.pos, win.loc2glob, points, win.point_ok))
    return kfs, lms


def global_bundle_adjustment(
    kfs: Keyframes,
    lms: Landmarks,
    kf_counter,
    cam: PinholeCamera,
    window: int = 16,
    stride: int | None = None,
    max_points: int = 4096,
    iterations: int = 4,
    sweeps: int = 2,
    huber_delta: float = 3.0,
    pose_prior: float = 2e3,
) -> Tuple[Keyframes, Landmarks, BAStats]:
    """Map-wide structure and pose refinement as overlapping
    block-Gauss-Seidel sweeps: a `window`-keyframe Schur solve slides
    over the whole insertion-ordered range with 50% overlap, each window
    anchored on its oldest pose, `sweeps` times. The number of chunks
    follows `kf_counter`, which is read on the host (an int costs no
    read)."""
    stride_ = stride if stride is not None else max(window // 2, 1)
    kfc = int(kf_counter)
    last_start = max(kfc - window, 0)
    # ceil division: the last chunk lands exactly on last_start, so the
    # newest keyframes are always covered
    n_chunks = (last_start + stride_ - 1) // stride_ + 1
    dev = kfs.R.device
    sq = torch.zeros(2, dtype=torch.float32, device=dev)
    n = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(sweeps):
        for c in range(n_chunks):
            win = gather_window(kfs, lms, kf_counter, window, max_points, start=min(c * stride_, last_start))
            poses, points, st = solve_window(
                win, cam, iterations=iterations, huber_delta=huber_delta, pose_prior=pose_prior
            )
            kfs, lms = scatter_window(kfs, lms, win, poses, points)
            nf = st.num_obs.to(torch.float32)
            sq = sq + torch.stack([st.rmse_before**2, st.rmse_after**2]) * nf
            n = n + nf
    # aggregated over every chunk solve (the overlap counts some
    # observations twice; a monitoring statistic)
    rmse = torch.sqrt(sq / torch.clamp(n, min=1.0))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    stats = BAStats(
        num_poses=torch.clamp(_i32(kf_counter, dev), max=kfs.capacity),
        num_points=zero,
        num_obs=(n / sweeps).to(torch.int32),
        rmse_before=rmse[0],
        rmse_after=rmse[1],
        points_dropped=zero,
    )
    return kfs, lms, stats


def local_bundle_adjustment(
    kfs: Keyframes,
    lms: Landmarks,
    kf_counter,
    cam: PinholeCamera,
    window: int = 8,
    max_points: int = 4096,
    iterations: int = 8,
    huber_delta: float = 3.0,
    n_fixed: int = 4,
    pose_prior: float = 2e3,
) -> Tuple[Keyframes, Landmarks, BAStats]:
    """Gather, solve, scatter: one local BA step."""
    win = gather_window(kfs, lms, kf_counter, window, max_points, n_fixed=n_fixed)
    poses, points, stats = solve_window(
        win, cam, iterations=iterations, huber_delta=huber_delta, pose_prior=pose_prior
    )
    kfs, lms = scatter_window(kfs, lms, win, poses, points)
    return kfs, lms, stats
