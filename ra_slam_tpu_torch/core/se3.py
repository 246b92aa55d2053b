"""SE(3)/SO(3) rigid transforms on tensors (counterpart of
`ra_slam_tpu/core/se3.py`).

`T = SE3(R, t)` maps `x -> R @ x + t`; a camera pose stored as
`cam_T_world` takes world points to camera points. Twists are
`[w, v]` (rotation first); quaternions are `(w, x, y, z)`.

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

_EPS = 1e-8


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


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

    def as_matrix34(self) -> torch.Tensor:
        """[..., 3, 4] matrix (the reference's trajectory row format)."""
        return torch.cat([self.R, self.t[..., :, None]], dim=-1)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_mv_fma(Rt, self.t))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform points [..., 3] (broadcasts over leading dims)."""
        return _mv(self.R, pts) + self.t

    def rotate(self, vecs: torch.Tensor) -> torch.Tensor:
        return _mv(self.R, vecs)

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: first apply `other`, then `self`."""
        return SE3(_mm(self.R, other.R), _mv(self.R, other.t) + self.t)

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)


def where_pose(cond: torch.Tensor, a: SE3, b: SE3) -> SE3:
    """Pose `a` where the boolean scalar `cond` holds, else `b`."""
    return SE3(torch.where(cond, a.R, b.R), torch.where(cond, a.t, b.t))


def hat_so3(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [..., 3, 3] of w [..., 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3], with
    series expansions near theta = 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat_so3(w)
    K2 = _mm(K, K)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return _eye_like(w) + a[..., None, None] * K + b[..., None, None] * K2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3], through the
    quaternion and atan2 (stable at theta ~ 0 and theta ~ pi)."""
    q = mat_to_quat(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    n = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    small = n < 1e-6
    scale = torch.where(
        small, 2.0 / torch.clamp(qw, min=_EPS), theta / torch.where(small, 1.0, n)
    )
    return qv * scale[..., None]


def _left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """V such that exp_se3([w, v]) translation = V @ v."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat_so3(w)
    K2 = _mm(K, K)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    return _eye_like(w) + b[..., None, None] * K + c[..., None, None] * K2


def exp_se3(xi: torch.Tensor) -> SE3:
    """se(3) twist [..., 6] ([w, v]) -> SE3."""
    w, v = xi[..., :3], xi[..., 3:]
    return SE3(exp_so3(w), _mv(_left_jacobian_so3(w), v))


def log_se3(T: SE3) -> torch.Tensor:
    """SE3 -> twist [..., 6] ([w, v]). The 3x3 solve is `solve_ex`: it
    reports a singular matrix in its `info` instead of checking it on
    the host, so it never waits for the device."""
    w = log_so3(T.R)
    V = _left_jacobian_so3(w)
    v = torch.linalg.solve_ex(V, T.t[..., None]).result[..., 0]
    return torch.cat([w, v], dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [..., 4] (w, x, y, z), w >= 0,
    by Shepperd's method: all four candidates, the largest pivot wins
    (the first on ties, as `jnp.argmax`)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1
    )
    case = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4, 4]
    idx = case[..., None, None].expand(*case.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, u) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_t = torch.sin(theta)
    small = sin_t < 1e-5
    safe = torch.where(small, 1.0, sin_t)
    w0 = torch.where(small, 1.0 - u, torch.sin((1.0 - u) * theta) / safe)
    w1 = torch.where(small, u, torch.sin(u * theta) / safe)
    q = w0 * q0 + w1 * q1
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
