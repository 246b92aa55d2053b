"""Voxel-map and SLAM state to and from numpy, in the JAX package's
layout.

`voxel_map_from_numpy` takes any object with the attribute layout of the
JAX package's `VoxelMap` (`table.key`, `table.value`, `block_key`, ...,
`free_top`), for example a JAX map whose leaves went through
`np.asarray`; `voxel_map_to_numpy` returns the same layout with numpy
leaves. `slam_state_from_numpy` / `slam_state_to_numpy` do the same for
the JAX package's `SlamState` (tracker, landmarks, keyframes, pose-graph
edges, loop-consistency state, per-frame statistics), and
`tree_from_numpy` / `tree_to_numpy` for any one of its parts or a BA
window (`Keyframes`, `Landmarks`, `PoseGraphEdges`, `BAWindow`, ...); the
uint32 descriptor words become the port's int32 bit patterns and back. A
map fused, or a sequence tracked, by one package can so be carried on by
the other.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.map.hash_table import HashTable
from ra_slam_tpu_torch.map.voxel_map import VoxelMap
from ra_slam_tpu_torch.slam.keyframes import Keyframes
from ra_slam_tpu_torch.slam.landmarks import Landmarks
from ra_slam_tpu_torch.slam.pose_graph import PoseGraphEdges
from ra_slam_tpu_torch.slam.system import SlamState
from ra_slam_tpu_torch.slam.tracker import TrackState

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


# nested state types, by the annotation of the field
_NESTED = {c.__name__: c for c in (TrackState, SE3, Landmarks, Keyframes, PoseGraphEdges)}


def tree_from_numpy(cls, arrays, device):
    """A port `cls` (one of the SLAM state dataclasses) on `device`
    holding a copy of `arrays`, an object with the JAX counterpart's
    attribute layout and numpy leaves (uint32 words viewed as int32)."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(arrays, f.name)
        if f.type in _NESTED:
            kw[f.name] = tree_from_numpy(_NESTED[f.type], v, device)
        else:
            a = np.asarray(v)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            kw[f.name] = _t(a, a.dtype, device)
    return cls(**kw)


def tree_to_numpy(obj) -> SimpleNamespace:
    """A SLAM state dataclass as numpy arrays in the JAX layout, with
    the descriptor words as uint32."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.type in _NESTED:
            out[f.name] = tree_to_numpy(v)
        else:
            a = v.cpu().numpy()
            out[f.name] = a.view(np.uint32) if f.name == "desc" else a
    return SimpleNamespace(**out)


def slam_state_from_numpy(arrays, device) -> SlamState:
    """A port `SlamState` on `device` holding a copy of `arrays` (the JAX
    `SlamState` layout, numpy leaves; uint32 words viewed as int32)."""
    return tree_from_numpy(SlamState, arrays, device)


def slam_state_to_numpy(state: SlamState) -> SimpleNamespace:
    """The state as numpy arrays in the JAX `SlamState` layout, with the
    descriptor words as uint32."""
    return tree_to_numpy(state)
