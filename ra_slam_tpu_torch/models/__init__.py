"""Learned components (counterpart of `ra_slam_tpu.models`)."""

from ra_slam_tpu_torch.models.segmentation import (
    InferenceEngine,
    SegmentationNet,
    make_train_step,
)

__all__ = ["InferenceEngine", "SegmentationNet", "make_train_step"]
