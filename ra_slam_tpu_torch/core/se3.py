"""SE(3) rigid transforms on tensors (counterpart of `ra_slam_tpu/core/se3.py`).

`T = SE3(R, t)` maps `x -> R @ x + t`; a camera pose stored as
`cam_T_world` takes world points to camera points.

Parity note: points are rotated with `torch.einsum` in the same
contraction as the JAX package's `_mv` (`"...ij,...j->...i"`), a matrix
product on both sides. Writing the three-term sum out by hand rounds
differently, and on the VGA synthetic orbit that flipped 8 of 15.36M
block keys against JAX — one flipped key reorders the free-row stack
and every slot after it. A single vector (the translation of `inverse`)
goes through `_mv_fma`, which rounds as XLA's matrix-vector product.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", m, v)


def _mv_fma(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m [..., 3, 3] @ v [..., 3] for single vectors, rounded as XLA's CPU
    dot rounds a matrix-vector product: a fused multiply-add chain over
    j = 0, 1, 2. (torch's matrix-vector product adds without FMA and
    differs in the last bit for most inputs.) Each FMA is computed in
    float64, where the product of two floats is exact."""
    acc = m[..., 0] * v[..., None, 0]
    for j in (1, 2):
        acc = (m[..., j].double() * v[..., None, j].double() + acc.double()).float()
    return acc


@dataclass(frozen=True)
class SE3:
    """Rigid transform: rotation matrix [..., 3, 3] + translation [..., 3]."""

    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(device, dtype=torch.float32) -> "SE3":
        return SE3(
            torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device),
        )

    @staticmethod
    def from_matrix(m: torch.Tensor) -> "SE3":
        """From a [..., 4, 4] (or [..., 3, 4]) homogeneous matrix."""
        return SE3(m[..., :3, :3].contiguous(), m[..., :3, 3].contiguous())

    def as_matrix(self) -> torch.Tensor:
        """[..., 4, 4] homogeneous matrix."""
        batch = self.t.shape[:-1]
        bottom = torch.tensor(
            [0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype, device=self.t.device
        ).expand(*batch, 1, 4)
        top = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_mv_fma(Rt, self.t))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform points [..., 3] (broadcasts over leading dims)."""
        return _mv(self.R, pts) + self.t
