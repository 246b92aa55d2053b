"""Pose-graph edges (counterpart of `ra_slam_tpu/slam/pose_graph.py`).

The frame step records an odometry edge between consecutive keyframes
in every configuration. Optimising the graph (`optimize_pose_graph`) and
moving the landmarks with it (`correct_landmarks`) wait for the
loop-closing port.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.slam.keyframes import set_row


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
