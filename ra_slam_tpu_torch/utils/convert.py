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


def _seg_layout(net):
    """(torch module prefix, flax path, kind) of every conv and group
    norm of a `SegmentationNet`, in the flax module names: the encoder
    blocks, the bottleneck and the decoder blocks are `ConvBlock_i` in
    that order, the decoder's upsampling convs `Conv_k`, the logits conv
    the last `Conv_k`."""
    levels = len(net.widths)
    blocks = [f"down.{i}" for i in range(levels - 1)] + ["bottom"] + [
        f"up_blocks.{k}" for k in range(levels - 1)]
    for b, prefix in enumerate(blocks):
        for j in (0, 1):
            yield f"{prefix}.convs.{j}", (f"ConvBlock_{b}", f"Conv_{j}"), "conv"
            yield f"{prefix}.norms.{j}", (f"ConvBlock_{b}", f"GroupNorm_{j}"), "norm"
    for k in range(levels - 1):
        yield f"up.{k}", (f"Conv_{k}",), "conv"
    yield "head", (f"Conv_{levels - 1}",), "conv"


def seg_state_dict_from_flax(tree, net):
    """The `state_dict` of `net` (a `SegmentationNet`) from a flax params
    tree with numpy leaves (`{"params": {"ConvBlock_0": {"Conv_0":
    {"kernel", "bias"}, "GroupNorm_0": {"scale", "bias"}, ...}, ...}}`):
    kernels HWIO -> OIHW. Raises ValueError, as `flax.serialization.
    from_bytes` does, where the tree lacks a module the net has, and
    where a leaf's shape differs."""
    expected: dict = {}
    for _, path, _ in _seg_layout(net):
        node = expected.setdefault("params", {})
        for key in path:
            node = node.setdefault(key, {})
    _check_keys(tree, expected, "")
    sd = {}
    for prefix, path, kind in _seg_layout(net):
        node = tree["params"]
        for key in path:
            node = node[key]
        if kind == "conv":
            leaves = {"weight": np.asarray(node["kernel"]).transpose(3, 2, 0, 1), "bias": node["bias"]}
        else:
            leaves = {"weight": node["scale"], "bias": node["bias"]}
        for name, value in leaves.items():
            sd[f"{prefix}.{name}"] = torch.from_numpy(np.array(value, np.float32, copy=True))
    want = net.state_dict()
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"checkpoint leaf for {k} has shape {tuple(v.shape)}, the net {tuple(want[k].shape)}")
    return sd


def _check_keys(tree, expected, path):
    """Raise as flax's `_restore_dict` does at the first mapping of `tree`
    that lacks keys `expected` has there."""
    missing = set(expected) - set(tree) if isinstance(tree, dict) else set(expected)
    if missing:
        raise ValueError(
            "The target dict keys and state dict keys do not match, target dict contains "
            f"keys {missing} which are not present in state dict at path {path or '/'}")
    for key, sub in expected.items():
        if sub:
            _check_keys(tree[key], sub, f"{path}/{key}")


def seg_state_dict_to_flax(sd, net):
    """The flax params tree (numpy float32 leaves, keys sorted as flax
    writes them) of `net`'s `state_dict`: kernels OIHW -> HWIO."""
    params: dict = {}
    for prefix, path, kind in _seg_layout(net):
        w, b = sd[f"{prefix}.weight"].detach().cpu().numpy(), sd[f"{prefix}.bias"].detach().cpu().numpy()
        leaf = ({"bias": b, "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0))} if kind == "conv"
                else {"bias": b, "scale": w})
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def _sorted(d):
        return {k: _sorted(d[k]) if isinstance(d[k], dict) else d[k] for k in sorted(d)}

    return {"params": _sorted(params)}
