"""The sparse voxel-block TSDF map (counterpart of `ra_slam_tpu.map`)."""

from ra_slam_tpu_torch.map.voxel_map import (
    VoxelMap,
    create_map,
    allocate_from_depth,
    integrate,
    integrate_frame,
    visible_blocks,
    space_carve,
    gather_valid,
    gather_valid_semantic,
)

__all__ = [
    "VoxelMap",
    "create_map",
    "allocate_from_depth",
    "integrate",
    "integrate_frame",
    "visible_blocks",
    "space_carve",
    "gather_valid",
    "gather_valid_semantic",
]
