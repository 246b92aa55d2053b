"""The numbers that decide `correct`, each against its limit.

Maps are compared block by block, by key: both sides as (sorted keys,
tsdf, weight, prob [K, 512], rgb [K, 3, 512]) float32 on one device.
Frames are compared pixel by pixel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


OFF = 1e-4  # a voxel's tsdf or weight differs when it differs by more than this


def map_numbers(prog, ref) -> Dict[str, float]:
    """`map_keys`: blocks held by one side only, over the blocks of both;
    `map_tsdf`, `map_weight`: the share of the voxels of the blocks both
    hold whose value differs by more than OFF; `map_prob`, `map_rgb`: the
    mean |difference| over those voxels (the UNet and the JPEG decoders
    leave every voxel a little apart)."""
    pk, rk = prog[0].to(torch.int64), ref[0].to(torch.int64)
    pos = torch.searchsorted(rk, pk).clamp(max=max(rk.numel() - 1, 0))
    hit = rk[pos] == pk if rk.numel() else torch.zeros_like(pk, dtype=torch.bool)
    common = int(hit.sum())
    union = pk.numel() + rk.numel() - common
    out = {"map_keys": (union - common) / max(union, 1)}
    pi, ri = torch.nonzero(hit).squeeze(1), pos[hit]
    for name, a, b in zip(("map_tsdf", "map_weight", "map_prob", "map_rgb"), prog[1:], ref[1:]):
        if not common:
            out[name] = float("inf")
            continue
        d = (a[pi] - b[ri]).abs()
        out[name] = float((d > OFF).float().mean() if name in ("map_tsdf", "map_weight") else d.mean())
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number that is missing or not finite fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        good = v == v and v <= limit
        ok = ok and good
        table[name] = {"value": v, "limit": limit}
    return ok, table
