"""Voxel-block geometry and key packing (counterpart of
`ra_slam_tpu/map/blocks.py`).

The map is a sparse set of 8x8x8-voxel blocks. Block coordinates pack
into one int32 key, 10 bits per axis biased by +512; coordinates
outside [-512, 511] map to INVALID_KEY.
"""

from __future__ import annotations

import torch

from ra_slam_tpu_torch.core.camera import to_i32

BLOCK_LEN = 8
BLOCK_VOLUME = BLOCK_LEN**3  # 512

KEY_BITS = 10
KEY_OFFSET = 1 << (KEY_BITS - 1)  # 512
KEY_MASK = (1 << KEY_BITS) - 1

INVALID_KEY = 0x7FFFFFFF

_FIB = 2654435769  # Fibonacci hashing multiplier, 2^32 / golden ratio
_OWNER_MUL = 2246822519  # shard-owner multiplier, independent of _FIB


def pack_block_coords(coords: torch.Tensor) -> torch.Tensor:
    """Block coords [..., 3] int32 -> packed int32 key."""
    c = coords + KEY_OFFSET
    in_range = ((c >= 0) & (c <= KEY_MASK)).all(dim=-1)
    key = (c[..., 0] << (2 * KEY_BITS)) | (c[..., 1] << KEY_BITS) | c[..., 2]
    return torch.where(in_range, key, INVALID_KEY).to(torch.int32)


def unpack_block_coords(key: torch.Tensor) -> torch.Tensor:
    """Packed int32 key -> block coords [..., 3] int32."""
    x = ((key >> (2 * KEY_BITS)) & KEY_MASK) - KEY_OFFSET
    y = ((key >> KEY_BITS) & KEY_MASK) - KEY_OFFSET
    z = (key & KEY_MASK) - KEY_OFFSET
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def hash_key(key: torch.Tensor, log2_size: int) -> torch.Tensor:
    """int32 key -> table index in [0, 2^log2_size).

    The JAX package's uint32 multiply-shift, computed in int64 (torch has
    no general uint32 arithmetic): the low 32 bits of the product are
    the uint32 product.
    """
    k = key.to(torch.int64) & 0xFFFFFFFF
    h = (k * _FIB) & 0xFFFFFFFF
    return (h >> (32 - log2_size)).to(torch.int32)


def owner_of(key: torch.Tensor, n_shards: int) -> torch.Tensor:
    """int32 key -> owning shard in [0, n_shards) for map sharding. Uses
    another multiplier than `hash_key`, so that the keys of one shard
    spread over its whole local table. The JAX package's uint32
    multiply, xor-shift and modulo, computed in int64 masked to 32 bits."""
    if n_shards == 1:
        return torch.zeros_like(key)
    h = ((key.to(torch.int64) & 0xFFFFFFFF) * _OWNER_MUL) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    return (h % n_shards).to(torch.int32)


def owner_slab(key: torch.Tensor, n_shards: int, cell_log2: int = 2) -> torch.Tensor:
    """Spatially coherent owner: round-robin x-slabs of 2^cell_log2
    blocks, owner = (bx >> cell_log2) mod n, with an arithmetic shift
    and a floor modulo (`torch.remainder`), so that negative bx wrap as
    in the JAX package. A block's 2x2x2 corner neighbourhood then
    crosses at most one slab boundary, in +x: every remote block a shard
    needs is a left-edge block (bx = 0 mod 2^c) of the next shard."""
    if n_shards == 1:
        return torch.zeros_like(key)
    bx = unpack_block_coords(key)[..., 0]
    return torch.remainder(bx >> cell_log2, n_shards).to(torch.int32)


def point_to_block(voxel_coords: torch.Tensor) -> torch.Tensor:
    """Global voxel coords [..., 3] -> containing block coords (floor div)."""
    return torch.div(voxel_coords, BLOCK_LEN, rounding_mode="floor")


def world_to_voxel(pts: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """World meters [..., 3] -> global voxel coords (floor)."""
    return to_i32(torch.floor(pts / voxel_size))


def voxel_offsets(device) -> torch.Tensor:
    """[512, 3] int32 intra-block voxel offsets, x-major (idx = x + 8y + 64z)."""
    idx = torch.arange(BLOCK_VOLUME, dtype=torch.int32, device=device)
    x = idx % BLOCK_LEN
    y = (idx // BLOCK_LEN) % BLOCK_LEN
    z = idx // (BLOCK_LEN * BLOCK_LEN)
    return torch.stack([x, y, z], dim=-1)
