"""Trajectory accuracy metrics: ATE and RPE (counterpart of
`ra_slam_tpu/eval/ate.py`, numpy only).

Absolute trajectory error after SE(3) (optionally Sim(3)) Umeyama
alignment, and relative pose error over a fixed frame delta, following
the TUM-RGBD protocol. Trajectories are `(frame_id, 3x4 cam_T_world)`
lists, as `SlamSystem.trajectory()` returns and `io.folder.
load_trajectory` reads.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Trajectory = Sequence[Tuple[int, np.ndarray]]


def _centers_by_id(traj: Trajectory) -> Dict[int, np.ndarray]:
    """frame_id -> camera center in world coords (cTw -> C = -R^T t)."""
    out = {}
    for fid, m in traj:
        R, t = np.asarray(m)[:3, :3], np.asarray(m)[:3, 3]
        out[int(fid)] = -R.T @ t
    return out


def _poses_by_id(traj: Trajectory) -> Dict[int, np.ndarray]:
    out = {}
    for fid, m in traj:
        T = np.eye(4)
        T[:3, :4] = np.asarray(m)[:3, :4]
        out[int(fid)] = T  # cam_T_world
    return out


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares (s, R, t) with dst ≈ s·R·src + t (Umeyama 1991).

    src/dst: [N, 3] point sets (camera centers).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est: Trajectory,
    gt: Trajectory,
    with_scale: bool = False,
) -> Dict[str, float]:
    """Absolute trajectory error of est vs gt over common frame ids.

    Returns rmse / mean / median / max translation error (meters) after
    Umeyama alignment, plus the number of matched frames.
    """
    ce, cg = _centers_by_id(est), _centers_by_id(gt)
    ids = sorted(set(ce) & set(cg))
    if len(ids) < 3:
        raise ValueError(f"only {len(ids)} common frames between est and gt")
    P = np.stack([ce[i] for i in ids])
    Q = np.stack([cg[i] for i in ids])
    s, R, t = umeyama_alignment(P, Q, with_scale=with_scale)
    err = np.linalg.norm((s * (R @ P.T).T + t) - Q, axis=1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(err**2))),
        "ate_mean": float(np.mean(err)),
        "ate_median": float(np.median(err)),
        "ate_max": float(np.max(err)),
        "matched_frames": len(ids),
        "scale": float(s),
    }


def rpe_rmse(
    est: Trajectory,
    gt: Trajectory,
    delta: int = 1,
) -> Dict[str, float]:
    """Relative pose error over frame pairs (i, i+delta): translational
    drift per step, no alignment needed (TUM-RGBD RPE protocol)."""
    pe, pg = _poses_by_id(est), _poses_by_id(gt)
    ids = sorted(set(pe) & set(pg))
    terr: List[float] = []
    rerr: List[float] = []
    idset = set(ids)
    for i in ids:
        j = i + delta
        if j not in idset:
            continue
        # relative motion cam_i -> cam_j: Tj · Ti^-1 (cTw convention)
        de = pe[j] @ np.linalg.inv(pe[i])
        dg = pg[j] @ np.linalg.inv(pg[i])
        e = np.linalg.inv(dg) @ de
        terr.append(float(np.linalg.norm(e[:3, 3])))
        c = (np.trace(e[:3, :3]) - 1.0) / 2.0
        rerr.append(float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))))
    if not terr:
        raise ValueError("no frame pairs at the requested delta")
    terr_a, rerr_a = np.asarray(terr), np.asarray(rerr)
    return {
        "rpe_trans_rmse": float(np.sqrt(np.mean(terr_a**2))),
        "rpe_rot_rmse_deg": float(np.sqrt(np.mean(rerr_a**2))),
        "pairs": len(terr),
    }
