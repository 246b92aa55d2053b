"""Loop-candidate retrieval, geometric verification and relocalization
(counterpart of `ra_slam_tpu/slam/loop_closure.py`).

Keyframes are embedded as mean ±1 descriptors, so retrieval is one
matrix-vector product against the whole keyframe database; verification
is mutual descriptor matching (two Hamming matrices, `ops/hamming.py`)
and a robust motion-only GN against the candidate's landmarks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import TrackingConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.features.matching import mutual_match, unpack_pm1
from ra_slam_tpu_torch.slam.keyframes import Keyframes
from ra_slam_tpu_torch.slam.landmarks import Landmarks
from ra_slam_tpu_torch.slam.pnp import motion_only_gn


@dataclass(frozen=True)
class LoopCandidate:
    cand: torch.Tensor  # int32 candidate keyframe slot (-1 = none)
    score: torch.Tensor  # float32 embedding similarity
    rel_pose: SE3  # query_T_cand
    num_inliers: torch.Tensor  # int32 verified inliers
    rmse: torch.Tensor  # float32 inlier reprojection rmse (px)
    accepted: torch.Tensor  # bool


def _slots(kfs: Keyframes) -> torch.Tensor:
    return torch.arange(kfs.capacity, device=kfs.R.device)


def retrieve_candidate(
    kfs: Keyframes,
    query_slot: torch.Tensor,
    kf_counter: torch.Tensor,
    min_gap: int = 30,
    min_score: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best loop candidate for `query_slot` by cosine embedding
    similarity, keyframes within `min_gap` of the query excluded.
    Returns (slot, score); slot = -1 when nothing clears `min_score`."""
    q = kfs.embed[query_slot.long()]
    norms = torch.linalg.vector_norm(kfs.embed, dim=-1)
    scores = (kfs.embed @ q) / torch.clamp(
        norms * torch.clamp(norms[query_slot.long()], min=1e-9), min=1e-9
    )
    slots = _slots(kfs)
    ok = kfs.valid & (slots < kf_counter) & ((slots - query_slot).abs() >= min_gap)
    scores = torch.where(ok, scores, float("-inf"))
    best = torch.argmax(scores)
    found = scores[best] > min_score
    return (
        torch.where(found, best, -1).to(torch.int32),
        torch.where(found, scores[best], 0.0),
    )


def _match_candidate(kfs, lms, desc, valid, cand, tcfg):
    """Mutual matches of query features against keyframe `cand`'s
    observations: (weights [F] float32, landmark positions [F, 3])."""
    c = cand.long()
    c_lm = kfs.obs_lm[c]
    matches = mutual_match(
        desc, valid, kfs.desc[c], (kfs.obs_w[c] > 0) & (c_lm >= 0),
        max_distance=tcfg.match_hamming_max, ratio=tcfg.match_ratio,
    )
    lm_idx = c_lm[matches.idx.long()]
    safe = torch.clamp(lm_idx, min=0).long()
    ok = matches.valid & (lm_idx >= 0) & lms.valid[safe]
    return ok.to(torch.float32), lms.pos[safe]


def verify_candidate(
    kfs: Keyframes,
    lms: Landmarks,
    query_slot: torch.Tensor,
    cand_slot: torch.Tensor,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    min_inliers: int = 25,
    iterations: int = 10,
    max_rmse: float = 2.0,
) -> LoopCandidate:
    """Match query -> candidate, solve the query pose against the
    candidate's landmarks from the candidate's pose, accept on inlier
    count and inlier rmse."""
    safe_cand = torch.clamp(cand_slot, min=0)
    q = query_slot.long()
    w, pts = _match_candidate(kfs, lms, kfs.desc[q], kfs.obs_w[q] > 0, safe_cand, tcfg)
    cand_pose = kfs.pose(safe_cand.long())
    res = motion_only_gn(
        cand_pose, pts, kfs.obs_uv[q], w, cam,
        iterations=iterations, huber_delta=tcfg.huber_delta,
    )
    accepted = (cand_slot >= 0) & (res.num_inliers >= min_inliers) & (res.rmse <= max_rmse)
    return LoopCandidate(
        cand=cand_slot,
        score=torch.zeros((), device=w.device),
        rel_pose=res.pose @ cand_pose.inverse(),
        num_inliers=res.num_inliers,
        rmse=res.rmse,
        accepted=accepted,
    )


@dataclass(frozen=True)
class RelocResult:
    pose: SE3  # recovered cam_T_world
    cand: torch.Tensor  # int32 keyframe the pose was recovered against
    score: torch.Tensor  # float32 retrieval similarity
    num_inliers: torch.Tensor  # int32
    accepted: torch.Tensor  # bool


def relocalize(
    kfs: Keyframes,
    lms: Landmarks,
    desc: torch.Tensor,  # [F, 8] int32 query-frame descriptors
    valid: torch.Tensor,  # [F] bool
    uv: torch.Tensor,  # [F, 2] float32 query-frame pixels
    kf_counter: torch.Tensor,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    min_inliers: int = 20,
    iterations: int = 10,
    max_rmse: float = 3.0,
    min_score: float = 0.1,
) -> RelocResult:
    """Re-acquire the pose after tracking loss: embed the frame like a
    keyframe, retrieve the most similar keyframe (no temporal gate),
    verify by mutual matching + robust GN against its landmarks."""
    w = valid.to(torch.float32)
    q = (unpack_pm1(desc) * w[:, None]).sum(dim=0) / torch.clamp(w.sum(), min=1.0)
    norms = torch.linalg.vector_norm(kfs.embed, dim=-1)
    qn = torch.clamp(torch.linalg.vector_norm(q), min=1e-9)
    scores = (kfs.embed @ q) / torch.clamp(norms * qn, min=1e-9)
    ok = kfs.valid & (_slots(kfs) < kf_counter)
    scores = torch.where(ok, scores, float("-inf"))
    cand = torch.argmax(scores).to(torch.int32)

    wm, pts = _match_candidate(kfs, lms, desc, valid, cand, tcfg)
    res = motion_only_gn(
        kfs.pose(cand.long()), pts, uv, wm, cam,
        iterations=iterations, huber_delta=tcfg.huber_delta,
    )
    score = scores[cand.long()]
    accepted = (
        ok.any() & (res.num_inliers >= min_inliers) & (res.rmse <= max_rmse) & (score >= min_score)
    )
    return RelocResult(
        pose=res.pose, cand=cand, score=score, num_inliers=res.num_inliers, accepted=accepted
    )


def detect_loop(
    kfs: Keyframes,
    lms: Landmarks,
    query_slot: torch.Tensor,
    kf_counter: torch.Tensor,
    cam: PinholeCamera,
    tcfg: TrackingConfig,
    min_gap: int = 30,
    min_score: float = 0.05,
    min_inliers: int = 25,
    max_rmse: float = 2.0,
) -> LoopCandidate:
    """Retrieve + verify."""
    cand, score = retrieve_candidate(kfs, query_slot, kf_counter, min_gap, min_score)
    out = verify_candidate(
        kfs, lms, query_slot, cand, cam, tcfg, min_inliers=min_inliers, max_rmse=max_rmse
    )
    return dataclasses.replace(out, score=score, accepted=out.accepted & (cand >= 0))
