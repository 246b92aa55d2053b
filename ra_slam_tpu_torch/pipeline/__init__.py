"""System facade and CLI entry points (counterpart of `ra_slam_tpu.pipeline`)."""

from ra_slam_tpu_torch.pipeline.system import RaSlamSystem

__all__ = ["RaSlamSystem"]
