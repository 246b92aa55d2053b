"""SE(3) pose-graph optimisation (counterpart of
`ra_slam_tpu/slam/pose_graph.py`).

Gauss-Newton over relative-pose edges with the residual

    r_e = log_se3( Z_ij^-1 · (T_i · T_j^-1) )      (cam_T_world poses)

Each edge's 6x6 Jacobians come from forward-mode differentiation of the
left-perturbed residual (`torch.func.jvp`, batched over the edges, as the
JAX package's `jax.jacfwd`). The normal system is assembled with
scatter-adds into a dense `[6K, 6K]` matrix, the gauge is fixed by a
strong prior on node 0, and the solve is one dense Cholesky. The product
and the factorisation run in float32 with TF32 off (the torch default;
nothing here turns it on): one reduced-precision pass loses the loop
correction under the 1e6 gauge prior.

`correct_landmarks` moves each landmark with its creation keyframe,
p' = T_new^-1 · T_old · p (OpenVSLAM's loop-correction rule).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from ra_slam_tpu_torch.core.se3 import SE3, exp_se3, log_se3
from ra_slam_tpu_torch.slam.keyframes import Keyframes, set_row
from ra_slam_tpu_torch.slam.landmarks import Landmarks


@dataclass(frozen=True)
class PoseGraphEdges:
    """Fixed-capacity relative-pose constraint set."""

    i: torch.Tensor  # [E] int32 source keyframe slot
    j: torch.Tensor  # [E] int32 target keyframe slot
    R: torch.Tensor  # [E, 3, 3] measured Z_ij = Ti · Tj^-1 rotation
    t: torch.Tensor  # [E, 3]
    weight: torch.Tensor  # [E] float32 information scale (0 = empty slot)

    @property
    def capacity(self) -> int:
        return self.i.shape[0]


def create_edges(capacity: int, device) -> PoseGraphEdges:
    return PoseGraphEdges(
        i=torch.zeros(capacity, dtype=torch.int32, device=device),
        j=torch.zeros(capacity, dtype=torch.int32, device=device),
        R=torch.eye(3, device=device).expand(capacity, 3, 3).contiguous(),
        t=torch.zeros(capacity, 3, device=device),
        weight=torch.zeros(capacity, device=device),
    )


def add_edge(
    edges: PoseGraphEdges, slot: torch.Tensor, i, j, z_ij: SE3, weight=1.0
) -> PoseGraphEdges:
    return PoseGraphEdges(
        i=set_row(edges.i, slot, i),
        j=set_row(edges.j, slot, j),
        R=set_row(edges.R, slot, z_ij.R),
        t=set_row(edges.t, slot, z_ij.t),
        weight=set_row(edges.weight, slot, weight),
    )


def odometry_edge(pose_i: SE3, pose_j: SE3) -> SE3:
    """Measurement from current estimates: Z_ij = T_i · T_j^-1."""
    return pose_i @ pose_j.inverse()


def _edge_residual(xi_i: torch.Tensor, xi_j: torch.Tensor, Ti: SE3, Tj: SE3, Zinv: SE3) -> torch.Tensor:
    Ti_p = exp_se3(xi_i) @ Ti
    Tj_p = exp_se3(xi_j) @ Tj
    return log_se3(Zinv @ (Ti_p @ Tj_p.inverse()))


def _edge_lin(Ti: SE3, Tj: SE3, Z: SE3):
    """(r [E, 6], J_i [E, 6, 6], J_j [E, 6, 6]) at the current poses.

    The Jacobians are the forward-mode derivatives at xi = 0, all 12
    basis directions in one pass: the edges are repeated 12 times and
    copy k carries the k-th unit tangent (k < 6 on xi_i, else xi_j)."""
    E = Ti.t.shape[0]
    dev, dt = Ti.t.device, Ti.t.dtype
    Zinv = Z.inverse()
    rep = lambda T: SE3(T.R.expand(12, *T.R.shape), T.t.expand(12, *T.t.shape))
    zero = torch.zeros(12, E, 6, dtype=dt, device=dev)
    basis = torch.eye(12, dtype=dt, device=dev)[:, None, :].expand(12, E, 12)
    r, dr = torch.func.jvp(
        lambda a, b: _edge_residual(a, b, rep(Ti), rep(Tj), rep(Zinv)),
        (zero, zero),
        (basis[..., :6], basis[..., 6:]),
    )
    J = dr.permute(1, 2, 0)  # [E, 6 (residual), 12 (direction)]
    return r[0], J[..., :6], J[..., 6:]


@dataclass(frozen=True)
class PoseGraphStats:
    rmse_before: torch.Tensor
    rmse_after: torch.Tensor


def optimize_pose_graph(
    kfs: Keyframes,
    edges: PoseGraphEdges,
    kf_counter,
    max_nodes: int,
    iterations: int = 10,
    damping: float = 1e-6,
    gauge_weight: float = 1e6,
) -> Tuple[Keyframes, PoseGraphStats]:
    """Optimise keyframe poses 0..kf_counter-1 over all weighted edges.

    `max_nodes` is the node capacity (normally `kfs.capacity`); nodes
    from `kf_counter` on are frozen by a unit prior, so shapes are
    fixed. Never reads a device value on the host."""
    K = max_nodes
    dev = kfs.R.device
    ar = torch.arange(K, device=dev)
    node_active = (ar < kf_counter) & kfs.valid[:K]
    ei, ej = edges.i.long(), edges.j.long()
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    # gauge prior on node 0; freeze inactive nodes
    prior = torch.where(ar == 0, gauge_weight, torch.where(node_active, 0.0, 1.0))
    Z = SE3(edges.R, edges.t)

    def solve_once(R, t):
        r, Ji, Jj = _edge_lin(SE3(R[ei], t[ei]), SE3(R[ej], t[ej]), Z)
        # edge validity: weight > 0, both endpoints active
        w = edges.weight * node_active[ei] * node_active[ej]
        rw = r * w[:, None]

        Hii = torch.einsum("eri,erj->eij", Ji * w[:, None, None], Ji)
        Hjj = torch.einsum("eri,erj->eij", Jj * w[:, None, None], Jj)
        Hij = torch.einsum("eri,erj->eij", Ji * w[:, None, None], Jj)
        gi = torch.einsum("eri,er->ei", Ji, rw)
        gj = torch.einsum("eri,er->ei", Jj, rw)

        Hb = torch.zeros(K, K, 6, 6, dtype=torch.float32, device=dev)
        Hb.index_put_((ei, ei), Hii, accumulate=True)
        Hb.index_put_((ej, ej), Hjj, accumulate=True)
        Hb.index_put_((ei, ej), Hij, accumulate=True)
        Hb.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
        g = torch.zeros(K, 6, dtype=torch.float32, device=dev)
        g.index_add_(0, ei, gi)
        g.index_add_(0, ej, gj)
        Hb[ar, ar] = Hb[ar, ar] + (prior + damping)[:, None, None] * eye6

        H = Hb.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        L, info = torch.linalg.cholesky_ex(H)
        dxi = -torch.cholesky_solve(g.reshape(6 * K, 1), L).reshape(K, 6)
        # a failed factorisation gives no step (JAX: NaN, then zeroed)
        dxi = torch.where((info == 0) & torch.isfinite(dxi), dxi, 0.0)
        dxi = torch.where(node_active[:, None], dxi, 0.0)

        new = exp_se3(dxi) @ SE3(R, t)
        chi2 = torch.sum(rw * r)
        nact = torch.clamp(torch.sum(w > 0), min=1)
        return new.R, new.t, torch.sqrt(chi2 / nact.to(torch.float32))

    R0, t0 = kfs.R[:K], kfs.t[:K]
    _, _, rmse_before = solve_once(R0, t0)
    R, t = R0, t0
    for _ in range(iterations):
        R, t, _ = solve_once(R, t)
    _, _, rmse_after = solve_once(R, t)
    kfs_out = dataclasses.replace(
        kfs, R=torch.cat([R, kfs.R[K:]]), t=torch.cat([t, kfs.t[K:]])
    )
    return kfs_out, PoseGraphStats(rmse_before=rmse_before, rmse_after=rmse_after)


def correct_landmarks(
    lms: Landmarks, old_kfs_R: torch.Tensor, old_kfs_t: torch.Tensor, new_kfs: Keyframes
) -> Landmarks:
    """Move every valid landmark with its creation (anchor) keyframe:
    p' = T_new^-1 · (T_old · p). Anchoring on the creation keyframe keeps
    a landmark that already agrees with the early map where it is."""
    anchor = torch.clamp(lms.anchor, 0, new_kfs.capacity - 1).long()
    T_old = SE3(old_kfs_R[anchor], old_kfs_t[anchor])
    T_new = SE3(new_kfs.R[anchor], new_kfs.t[anchor])
    p_new = T_new.inverse().apply(T_old.apply(lms.pos))
    return dataclasses.replace(lms, pos=torch.where(lms.valid[:, None], p_new, lms.pos))
