"""Utilities (counterpart of `ra_slam_tpu.utils`)."""

from ra_slam_tpu_torch.utils.pose_buffer import PoseBuffer

__all__ = ["PoseBuffer"]
