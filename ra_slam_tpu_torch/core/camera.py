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

    def matrix(self, device) -> torch.Tensor:
        """[3, 3] float32 K matrix."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device,
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

    def pixel_grid(self, device) -> torch.Tensor:
        """[H, W, 2] float32 grid of (u, v) pixel-center coordinates."""
        v, u = torch.meshgrid(
            torch.arange(self.height, dtype=torch.float32, device=device),
            torch.arange(self.width, dtype=torch.float32, device=device),
            indexing="ij",
        )
        return torch.stack([u, v], dim=-1)

    def in_bounds(self, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        """Boolean mask: uv within the image rectangle."""
        u, v = uv[..., 0], uv[..., 1]
        return (
            (u >= margin)
            & (u <= self.width - 1 - margin)
            & (v >= margin)
            & (v <= self.height - 1 - margin)
        )

    def resized(self, new_width: int, new_height: int) -> "PinholeCamera":
        # float32 arithmetic, as the JAX camera's f32 fields scale
        sx = np.float32(new_width / self.width)
        sy = np.float32(new_height / self.height)
        return PinholeCamera(
            _f32(np.float32(self.fx) * sx), _f32(np.float32(self.fy) * sy),
            _f32(np.float32(self.cx) * sx), _f32(np.float32(self.cy) * sy),
            new_width, new_height,
        )


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: NaN to 0, out-of-range values
    saturate to INT_MIN / INT_MAX (torch's cast gives INT_MIN for both)."""
    x = torch.nan_to_num(x, nan=0.0)
    out = x.clamp(-(2.0**31), 2147483520.0).to(torch.int32)
    return torch.where(x >= 2.0**31, torch.iinfo(torch.int32).max, out)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor, fill: float = 0.0):
    """Bilinearly sample img [H, W] or [H, W, C] at continuous uv [..., 2].

    Returns (values, valid_mask). Out-of-bounds samples return `fill`.
    """
    H, W = img.shape[0], img.shape[1]
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0i = to_i32(u0)
    v0i = to_i32(v0)
    valid = (u0i >= 0) & (u0i < W - 1) & (v0i >= 0) & (v0i < H - 1)
    u0c = torch.clamp(u0i, 0, W - 2).long()
    v0c = torch.clamp(v0i, 0, H - 2).long()
    p00 = img[v0c, u0c]
    p01 = img[v0c, u0c + 1]
    p10 = img[v0c + 1, u0c]
    p11 = img[v0c + 1, u0c + 1]
    if img.ndim == 3:
        du, dv, vmask = du[..., None], dv[..., None], valid[..., None]
    else:
        vmask = valid
    out = (
        p00 * (1 - du) * (1 - dv)
        + p01 * du * (1 - dv)
        + p10 * (1 - du) * dv
        + p11 * du * dv
    )
    return torch.where(vmask, out, fill), valid


def nearest_sample(img: torch.Tensor, uv: torch.Tensor, fill: float = 0.0):
    """Nearest-neighbour sample (round half to even, as `jnp.round`).
    Returns (values, valid_mask)."""
    H, W = img.shape[0], img.shape[1]
    ui = to_i32(torch.round(uv[..., 0]))
    vi = to_i32(torch.round(uv[..., 1]))
    valid = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    vals = img[torch.clamp(vi, 0, H - 1).long(), torch.clamp(ui, 0, W - 1).long()]
    vmask = valid[..., None] if img.ndim == 3 else valid
    return torch.where(vmask, vals, fill), valid
