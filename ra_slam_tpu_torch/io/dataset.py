"""Dataset abstractions (numpy copy of `ra_slam_tpu/io/dataset.py`).

An RGB-D sequence: intrinsics, per-frame color/depth/pose, size.
Host-side Python; device code consumes the arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ra_slam_tpu_torch.core.camera import PinholeCamera


@dataclasses.dataclass
class Frame:
    """One RGB-D frame. Images are numpy (host) arrays."""

    frame_id: int
    timestamp: float
    rgb: np.ndarray  # [H, W, 3] uint8
    depth: np.ndarray  # [H, W] float32 meters
    # ground-truth / tracked pose, world -> camera (cam_T_world); None if unknown
    cam_T_world: Optional[np.ndarray] = None  # [4, 4] float32
    # optional semantic probability maps
    ht: Optional[np.ndarray] = None  # [H, W] float32
    lt: Optional[np.ndarray] = None


class RGBDDataset:
    """Abstract RGB-D sequence."""

    def __len__(self) -> int:
        raise NotImplementedError

    @property
    def camera(self) -> PinholeCamera:
        raise NotImplementedError

    @property
    def depth_factor(self) -> float:
        """Raw depth units per meter (reference depthmap_factor)."""
        return 1.0

    def frame(self, idx: int) -> Frame:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Frame]:
        for i in range(len(self)):
            yield self.frame(i)
