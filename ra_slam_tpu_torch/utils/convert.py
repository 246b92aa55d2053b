"""Voxel-map state to and from numpy, in the JAX package's layout.

`voxel_map_from_numpy` takes any object with the attribute layout of the
JAX package's `VoxelMap` (`table.key`, `table.value`, `block_key`, ...,
`free_top`), for example a JAX map whose leaves went through
`np.asarray`; `voxel_map_to_numpy` returns the same layout with numpy
leaves. A map fused by one package can so be carried on by the other.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ra_slam_tpu_torch.map.hash_table import HashTable
from ra_slam_tpu_torch.map.voxel_map import VoxelMap

_FIELDS = (
    ("block_key", np.int32),
    ("block_slot", np.int32),
    ("active", np.bool_),
    ("tsdf", np.float32),
    ("weight", np.float32),
    ("rgb", np.float32),
    ("prob", np.float32),
    ("alloc_failures", np.int32),
    ("free_stack", np.int32),
    ("free_top", np.int32),
)


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def voxel_map_from_numpy(arrays, device) -> VoxelMap:
    """A port `VoxelMap` on `device` holding a copy of `arrays`."""
    table = HashTable(
        key=_t(arrays.table.key, np.int32, device),
        value=_t(arrays.table.value, np.int32, device),
    )
    return VoxelMap(
        table=table,
        **{name: _t(getattr(arrays, name), dtype, device) for name, dtype in _FIELDS},
    )


def voxel_map_to_numpy(m: VoxelMap) -> SimpleNamespace:
    """The map's state as numpy arrays, in the JAX `VoxelMap` layout."""
    return SimpleNamespace(
        table=SimpleNamespace(key=m.table.key.cpu().numpy(), value=m.table.value.cpu().numpy()),
        **{name: getattr(m, name).cpu().numpy() for name, _ in _FIELDS},
    )
