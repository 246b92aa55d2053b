"""Pinhole camera model (counterpart of `ra_slam_tpu/core/camera.py`).

The intrinsics are Python floats holding float32 values, so that every
tensor expression using them rounds as the JAX package's float32
scalars do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class PinholeCamera:
    """Pinhole intrinsics + image size."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480

    @staticmethod
    def create(fx, fy, cx, cy, width, height, scale: float = 1.0) -> "PinholeCamera":
        """Build, optionally rescaling intrinsics to a resized image."""
        return PinholeCamera(
            _f32(fx * scale), _f32(fy * scale), _f32(cx * scale), _f32(cy * scale),
            int(round(width * scale)), int(round(height * scale)),
        )

    def project(self, pts_cam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Camera-frame points [..., 3] -> (pixel uv [..., 2], depth [...])."""
        z = pts_cam[..., 2]
        inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        u = pts_cam[..., 0] * inv_z * self.fx + self.cx
        v = pts_cam[..., 1] * inv_z * self.fy + self.cy
        return torch.stack([u, v], dim=-1), z

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Pixels [..., 2] + depth [...] -> camera-frame points [..., 3]."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)

    def resized(self, new_width: int, new_height: int) -> "PinholeCamera":
        # float32 arithmetic, as the JAX camera's f32 fields scale
        sx = np.float32(new_width / self.width)
        sy = np.float32(new_height / self.height)
        return PinholeCamera(
            _f32(np.float32(self.fx) * sx), _f32(np.float32(self.fy) * sy),
            _f32(np.float32(self.cx) * sx), _f32(np.float32(self.cy) * sy),
            new_width, new_height,
        )
