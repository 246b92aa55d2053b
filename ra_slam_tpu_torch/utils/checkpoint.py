"""Checkpoint / resume (counterpart of `ra_slam_tpu/utils/checkpoint.py`).

Every state of the system is a tree of fixed-shape tensors (dataclasses
of tensors), so one npz round trip covers it: the voxel map, the SLAM
state (tracker, keyframes, landmarks, pose-graph edges) and the host
counters. Leaves are named as `jax.tree_util.keystr` names the JAX
package's leaves (`.table.key`, `.block_key`, ... for the map), so a
checkpoint written by either package loads into the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from ra_slam_tpu_torch.map.voxel_map import VoxelMap

_FREE_STACK = (".free_stack", ".free_top")


def _named_leaves(tree: Any, prefix: str = ""):
    """(key-path name, tensor) pairs: `.field` for a dataclass field,
    `['key']` for a dict entry, `[i]` for a sequence item. Capacities
    (shapes) are part of the contract: a checkpoint loads only into a
    system built with the same configuration."""
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _named_leaves(getattr(tree, f.name), f"{prefix}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rebuild(tree: Any, leaves: dict, prefix: str = ""):
    """`tree` with each leaf replaced by `leaves[name]`."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves, f"{prefix}.{f.name}")
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return leaves[prefix]


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors as an npz keyed by key-path name."""
    np.savez_compressed(
        path, **{name: torch.as_tensor(v).cpu().numpy() for name, v in _named_leaves(tree)}
    )


def _free_stack_from_active(active: np.ndarray):
    """(free_stack, free_top) of a map whose file predates the free-row
    stack: the free rows first (ascending; the allocator pops from the
    top), then the active rows."""
    free = np.flatnonzero(~active).astype(np.int32)
    stack = np.concatenate([free, np.flatnonzero(active).astype(np.int32)])
    return stack, np.int32(len(free))


def load_pytree(path: str, template: Any) -> Any:
    """Load an npz written by `save_pytree` (of either package) into
    `template`'s structure, each leaf on its template's device with its
    template's dtype; shapes must match. A map file without the free-row
    stack gets it rebuilt from `active`."""
    data = np.load(path)
    named = dict(_named_leaves(template))
    arrays = {}
    for name in named:
        if name in data:
            arrays[name] = data[name]
        elif not (isinstance(template, VoxelMap) and name in _FREE_STACK):
            raise KeyError(
                f"checkpoint {path} has no entry for leaf {name!r} "
                f"(saved by an incompatible version?)"
            )
    if isinstance(template, VoxelMap) and not all(k in arrays for k in _FREE_STACK):
        arrays[".free_stack"], arrays[".free_top"] = _free_stack_from_active(arrays[".active"])
    leaves = {}
    for name, t in named.items():
        arr = arrays[name]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(
                f"leaf {name}: checkpoint shape {arr.shape} != template "
                f"{tuple(t.shape)} (different config?)"
            )
        # uint32 descriptor words of the JAX package keep their bits as int32
        a = arr.view(np.int32) if arr.dtype == np.uint32 and t.dtype == torch.int32 else arr
        leaves[name] = torch.as_tensor(np.array(a)).to(device=t.device, dtype=t.dtype)
    return _rebuild(template, leaves)


def save_system(ckpt_dir: str, system) -> None:
    """Checkpoint a `RaSlamSystem`: voxel map + SLAM state + pose buffer
    + host counters, in the JAX package's files."""
    os.makedirs(ckpt_dir, exist_ok=True)
    save_pytree(os.path.join(ckpt_dir, "map.npz"), system.map)
    meta = {"num_integrated": system.num_integrated}
    if system.slam is not None:
        save_pytree(os.path.join(ckpt_dir, "slam.npz"), system.slam.state)
        meta["frames"] = system.slam._frames
        meta["pose_buffer"] = [
            (t, p.R.tolist(), p.t.tolist()) for t, p in system.slam.pose_buffer.entries()
        ]
    np.savez_compressed(
        os.path.join(ckpt_dir, "meta.npz"), meta=np.array([repr(meta)], dtype=object)
    )


def load_system(ckpt_dir: str, system) -> None:
    """Restore a checkpoint into a freshly built `RaSlamSystem` of the
    same configuration, in place."""
    from ast import literal_eval

    from ra_slam_tpu_torch.core.se3 import SE3

    system.map = load_pytree(os.path.join(ckpt_dir, "map.npz"), system.map)
    # meta.npz holds one repr string that this program (or the JAX
    # package) wrote, as an object array
    meta = literal_eval(str(np.load(os.path.join(ckpt_dir, "meta.npz"), allow_pickle=True)["meta"][0]))
    system.num_integrated = meta["num_integrated"]
    if system.slam is not None and os.path.exists(os.path.join(ckpt_dir, "slam.npz")):
        system.slam.state = load_pytree(os.path.join(ckpt_dir, "slam.npz"), system.slam.state)
        system.slam._frames = [tuple(f) for f in meta["frames"]]
        for t, R, tr in meta.get("pose_buffer", []):
            system.slam.pose_buffer.register(
                t, SE3(torch.tensor(R, dtype=torch.float32), torch.tensor(tr, dtype=torch.float32))
            )
