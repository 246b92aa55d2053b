"""Tracked poses judged against the ground truth of the walk, in float64
numpy.

The SLAM world is the first left camera's frame of a session, so the
true camera-to-world of frame i there is Q_i = W_0^-1 W_i, with W the
walk's world_T_cam. The program's camera-to-world is P_i, the inverse of
the cam_T_world it tracked. Over consecutive frames that both tracked,
the relative pose error E = (Q_i^-1 Q_{i+1})^-1 (P_i^-1 P_{i+1}) gives
`track_rpe_m` (|translation of E|) and `track_rpe_deg` (the angle of its
rotation), each the root mean square over the pairs. `track_ate_m` is
the absolute trajectory error of the TUM RGB-D protocol: the root mean
square of |R c_i + t - t(Q_i)| over the tracked frames, for the camera
centres c_i = t(P_i) and the rigid motion (R, t) that fits them to the
truth best (Umeyama's SE(3) alignment, per session); `track_ate_anchored_m`
the same without the alignment, the first frame as the anchor.
"""

from __future__ import annotations

from typing import List

import numpy as np


def cam_T_world(flat: np.ndarray) -> np.ndarray:
    """[4, 4] float64 of a pose flattened as R (9, row-major) then t (3)."""
    m = np.eye(4)
    m[:3, :3] = np.asarray(flat[:9], np.float64).reshape(3, 3)
    m[:3, 3] = np.asarray(flat[9:12], np.float64)
    return m


def _angle_deg(R: np.ndarray) -> np.ndarray:
    """Rotation angle from the skew part (sin) and the trace (cos): near
    the identity this stays exact for a matrix a little off orthonormal,
    where the arccos of the trace alone does not."""
    s = 0.5 * np.linalg.norm(np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                                       R[..., 1, 0] - R[..., 0, 1]], axis=-1), axis=-1)
    c = 0.5 * (np.trace(R, axis1=-2, axis2=-1) - 1.0)
    return np.degrees(np.arctan2(s, c))


def align_se3(src: np.ndarray, dst: np.ndarray):
    """(R, t) minimising sum |R src_i + t - dst_i|^2 over [n, 3] points
    (Umeyama 1991, no scale)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def pose_errors(est_cTw: np.ndarray, tracked: np.ndarray, world_T_cam: np.ndarray) -> dict:
    """Squared errors of one session: est_cTw [n, 4, 4] tracked poses,
    tracked [n] flags, world_T_cam [n, 4, 4] the truth of those frames
    (the session's first frame first)."""
    Q = np.linalg.inv(world_T_cam[0])[None] @ world_T_cam
    P = np.linalg.inv(est_cTw)
    ok = np.asarray(tracked, bool)
    c_est, c_gt = P[ok, :3, 3], Q[ok, :3, 3]
    anchored = np.sum((c_est - c_gt) ** 2, axis=1)
    if len(c_est) >= 3:
        R, t = align_se3(c_est, c_gt)
        ate = np.sum((c_est @ R.T + t - c_gt) ** 2, axis=1)
    else:
        ate = anchored
    pair = ok[:-1] & ok[1:]
    dQ = np.linalg.inv(Q[:-1]) @ Q[1:]
    dP = np.linalg.inv(P[:-1]) @ P[1:]
    E = (np.linalg.inv(dQ) @ dP)[pair]
    return {"ate2": ate, "ate_anchored2": anchored, "rpe_t2": np.sum(E[:, :3, 3] ** 2, axis=1), "rpe_r2": _angle_deg(E[:, :3, :3]) ** 2}


def combine(errs: List[dict]) -> dict:
    cat = lambda k: np.concatenate([e[k] for e in errs]) if errs else np.zeros(0)
    rms = lambda a: float(np.sqrt(a.mean())) if a.size else float("inf")
    return {"track_rpe_m": rms(cat("rpe_t2")), "track_rpe_deg": rms(cat("rpe_r2")), "track_ate_m": rms(cat("ate2")),
            "track_ate_anchored_m": rms(cat("ate_anchored2"))}


def bf16(a: np.ndarray) -> np.ndarray:
    """Round float64 values to bfloat16 (round to nearest even), as float64."""
    f = np.asarray(a, np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)
