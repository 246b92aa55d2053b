"""Sparse visual SLAM: landmarks, motion-only GN, tracking, keyframes,
pose-graph edges, loop detection and relocalization, the frame step
(counterpart of `ra_slam_tpu.slam`)."""

from ra_slam_tpu_torch.slam.pnp import (
    PnPResult,
    motion_only_gn,
    reprojection_residuals,
)

__all__ = [
    "PnPResult",
    "motion_only_gn",
    "reprojection_residuals",
]
