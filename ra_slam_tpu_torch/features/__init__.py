"""ORB features: pyramid, FAST, descriptors, matching (counterpart of
`ra_slam_tpu.features`)."""

from ra_slam_tpu_torch.features.pyramid import build_pyramid, gaussian_blur
from ra_slam_tpu_torch.features.fast import fast_corners, fast_score
from ra_slam_tpu_torch.features.orb import (
    Keypoints,
    detect_and_describe,
    orb_descriptors,
    orientation,
)
from ra_slam_tpu_torch.features.matching import (
    Matches,
    hamming_matrix,
    hamming_matrix_popcount,
    match_descriptors,
    mutual_match,
)

__all__ = [
    "build_pyramid",
    "gaussian_blur",
    "fast_corners",
    "fast_score",
    "Keypoints",
    "detect_and_describe",
    "orb_descriptors",
    "orientation",
    "Matches",
    "hamming_matrix",
    "hamming_matrix_popcount",
    "match_descriptors",
    "mutual_match",
]
