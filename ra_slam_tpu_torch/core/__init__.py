"""Geometry and configuration (counterpart of `ra_slam_tpu.core`)."""

from ra_slam_tpu_torch.core.se3 import (
    SE3,
    exp_so3,
    log_so3,
    exp_se3,
    log_se3,
    quat_to_mat,
    mat_to_quat,
    quat_slerp,
)
from ra_slam_tpu_torch.core.camera import PinholeCamera

__all__ = [
    "SE3",
    "exp_so3",
    "log_so3",
    "exp_se3",
    "log_se3",
    "quat_to_mat",
    "mat_to_quat",
    "quat_slerp",
    "PinholeCamera",
]
