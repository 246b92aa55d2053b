"""Analytic map construction (counterpart of `ra_slam_tpu/map/synthetic_map.py`).

Builds a `VoxelMap` of the box room of `io/synthetic.py` straight from
its closed-form signed distance instead of fusing frames: one
`allocate_keys` call for every block near a wall, then the payload
written analytically. Meshing and raycast read it without a fusion run
first (the tests and `chip_smoke.py` use it so).
"""

from __future__ import annotations

import numpy as np
import torch

from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.map.blocks import (  # noqa: F401  (re-exports INVALID_KEY, as JAX does)
    BLOCK_LEN, INVALID_KEY, pack_block_coords, unpack_block_coords, voxel_offsets,
)
from ra_slam_tpu_torch.map.voxel_map import VoxelMap, _div, allocate_keys, create_map


def _box_room_sdf_np(p: np.ndarray, half_extents) -> np.ndarray:
    """Signed distance to the box-room walls, positive inside the room."""
    hx, hy, hz = half_extents
    return np.minimum(
        np.minimum(hx - np.abs(p[..., 0]), hy - np.abs(p[..., 1])),
        hz - np.abs(p[..., 2]),
    )


def analytic_box_map(
    cfg: TsdfConfig,
    device,
    half_extents=(3.0, 2.0, 3.0),
    band: float | None = None,
    weight: float = 40.0,
) -> VoxelMap:
    """A map of the box room on `device`: every block whose center lies
    within `band` (default: truncation + 0.9 of a block edge) of a wall is
    allocated; tsdf = clip(sdf / truncation, -1, 1), weight = `weight`
    inside the truncation band and 1 outside, prob 0.5.

    Metadata, table and free stack equal the JAX package's exactly, the
    payload to float32 rounding (tests/test_torch_meshing.py)."""
    if band is None:
        band = cfg.truncation + BLOCK_LEN * cfg.voxel_size * 0.9

    bs = BLOCK_LEN * cfg.voxel_size
    r = np.array(half_extents) / bs
    lo = np.floor(-r - 1).astype(np.int64)
    hi = np.ceil(r + 1).astype(np.int64)
    ax = [np.arange(lo[i], hi[i] + 1, dtype=np.int32) for i in range(3)]
    gx, gy, gz = np.meshgrid(*ax, indexing="ij")
    coords = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    centers = (coords.astype(np.float64) + 0.5) * bs
    coords = coords[np.abs(_box_room_sdf_np(centers, half_extents)) <= band]

    m = create_map(cfg, device)
    keys = pack_block_coords(torch.as_tensor(coords, device=device))
    allocate_keys(m, keys, max_new_blocks=min(len(coords), cfg.num_blocks))
    if int(m.alloc_failures) != 0:
        raise ValueError(
            f"analytic map of {len(coords)} blocks overflowed the pool of {cfg.num_blocks}"
        )
    _write_box_payload(m, cfg.voxel_size, cfg.truncation, half_extents, weight)
    return m


def _write_box_payload(m: VoxelMap, voxel_size, truncation, half_extents, weight) -> None:
    """tsdf/weight/prob of every active block from the box-room SDF, in
    place (lattice position (block*8 + offset) * voxel_size, the lattice
    `map/meshing.py` decodes)."""
    dev = m.device
    coords = unpack_block_coords(torch.where(m.active, m.block_key, 0))
    pos = (
        coords[:, None, :].to(torch.float32) * BLOCK_LEN + voxel_offsets(dev)[None]
    ) * voxel_size  # [N, 512, 3]
    he = torch.tensor(half_extents, dtype=torch.float32, device=dev)
    sdf = (he - pos.abs()).amin(dim=-1)
    tsdf = torch.clamp(_div(sdf, truncation), -1.0, 1.0)
    w = torch.where(sdf.abs() <= truncation, torch.tensor(weight, dtype=torch.float32, device=dev), 1.0)
    act = m.active[:, None]
    m.tsdf.copy_(torch.where(act, tsdf, m.tsdf))
    m.weight.copy_(torch.where(act, w, m.weight))
    m.prob.copy_(torch.where(act, 0.5, m.prob))
