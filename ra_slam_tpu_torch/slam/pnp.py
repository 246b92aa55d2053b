"""Motion-only pose estimation: batched Gauss-Newton on SE(3)
(counterpart of `ra_slam_tpu/slam/pnp.py`).

Residuals and analytic Jacobians of all correspondences in one pass, the
6x6 normal equations by einsum, a left-multiplicative update
`T <- exp(dxi) @ T` with twist [w, v], a fixed number of iterations.
The 6x6 solve is `torch.linalg.solve_ex`: `solve` would check the result
on the host, a device sync in every iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.se3 import SE3, exp_se3


@dataclass(frozen=True)
class PnPResult:
    pose: SE3  # refined cam_T_world
    inliers: torch.Tensor  # [N] bool final chi2 inlier mask
    num_inliers: torch.Tensor  # int32
    rmse: torch.Tensor  # float32 reprojection RMSE over inliers (px)


def reprojection_residuals(
    pose: SE3, pts_world: torch.Tensor, uv_obs: torch.Tensor, cam: PinholeCamera
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals [N, 2] = proj(T x) - uv, Jacobians [N, 2, 6] wrt the
    left-multiplicative twist [w, v], and a validity mask (z > eps)."""
    p = pose.apply(pts_world)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ok = z > 1e-6
    inv_z = 1.0 / torch.where(ok, z, 1.0)
    u = x * inv_z * cam.fx + cam.cx
    v = y * inv_z * cam.fy + cam.cy
    r = torch.stack([u, v], -1) - uv_obs

    fx, fy = cam.fx, cam.fy
    zero = torch.zeros_like(x)
    J_proj = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], -1),
        ],
        -2,
    )  # [N, 2, 3]
    # dp/dxi for left-multiplied exp(xi) T: dp = -[p]x w + v
    px = torch.stack(
        [
            torch.stack([zero, z, -y], -1),
            torch.stack([-z, zero, x], -1),
            torch.stack([y, -x, zero], -1),
        ],
        -2,
    )  # [N, 3, 3] = -[p]_x
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand_as(px)
    J = torch.matmul(J_proj, torch.cat([px, eye], dim=-1))  # [N, 2, 6]
    return r, J, ok


def _huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber loss on squared residual norm r2."""
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(r <= delta, 1.0, delta / r)


def _depth_residuals(
    pose: SE3, pts_world: torch.Tensor, d_obs: torch.Tensor, cam: PinholeCamera
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pixel-scaled depth residual r_z = fx·(z - d)/z and its [N, 6]
    twist Jacobian (the RGB-D analog of a virtual right-camera
    coordinate)."""
    p = pose.apply(pts_world)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ok = (z > 1e-6) & (d_obs > 0)
    zs = torch.where(z > 1e-6, z, 1.0)
    r = cam.fx * (zs - d_obs) / zs
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    dz = torch.stack([y, -x, zero, zero, zero, one], -1)  # [N, 6]
    J = (cam.fx * d_obs / (zs * zs))[:, None] * dz
    return r, J, ok


def motion_only_gn(
    pose0: SE3,
    pts_world: torch.Tensor,  # [N, 3]
    uv_obs: torch.Tensor,  # [N, 2]
    weights: torch.Tensor,  # [N] per-point weight (0 = ignore)
    cam: PinholeCamera,
    iterations: int = 10,
    huber_delta: float = 5.0,
    chi2_inlier: float = 5.991,
    damping: float = 1e-6,
    depth_obs: Optional[torch.Tensor] = None,  # [N] measured depth (m), <=0 none
    depth_weight: float = 0.5,
) -> PnPResult:
    """Gauss-Newton pose refinement over a fixed number of iterations;
    with `depth_obs`, points with measured depth add a pixel-scaled depth
    residual."""
    eye6 = torch.eye(6, dtype=weights.dtype, device=weights.device)
    pose = pose0
    for _ in range(iterations):
        r, J, ok = reprojection_residuals(pose, pts_world, uv_obs, cam)
        r2 = torch.sum(r * r, -1)
        w = weights * ok * _huber_weight(r2, huber_delta)
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        g = torch.einsum("nri,nr->i", Jw, r)
        if depth_obs is not None:
            rz, Jz, okz = _depth_residuals(pose, pts_world, depth_obs, cam)
            wz = depth_weight * weights * okz * _huber_weight(rz * rz, huber_delta)
            Jzw = Jz * wz[:, None]
            H = H + torch.einsum("ni,nj->ij", Jzw, Jz)
            g = g + torch.einsum("ni,n->i", Jzw, rz)
        H = H + damping * eye6
        dxi = -torch.linalg.solve_ex(H, g[:, None]).result[:, 0]
        # bad conditioning -> no update
        dxi = torch.where(torch.isfinite(dxi).all(), dxi, torch.zeros_like(dxi))
        pose = exp_se3(dxi) @ pose

    r, _, ok = reprojection_residuals(pose, pts_world, uv_obs, cam)
    r2 = torch.sum(r * r, -1)
    inl = (weights > 0) & ok & (r2 < chi2_inlier * huber_delta)
    n_inl = inl.sum(dtype=torch.int32)
    rmse = torch.sqrt(
        torch.where(inl, r2, 0.0).sum() / torch.clamp(n_inl.to(r2.dtype), min=1.0)
    )
    return PnPResult(pose=pose, inliers=inl, num_inliers=n_inl, rmse=rmse)
