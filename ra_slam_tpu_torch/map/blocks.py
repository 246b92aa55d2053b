"""Voxel-block geometry and key packing (counterpart of
`ra_slam_tpu/map/blocks.py`).

The map is a sparse set of 8x8x8-voxel blocks. Block coordinates pack
into one int32 key, 10 bits per axis biased by +512; coordinates
outside [-512, 511] map to INVALID_KEY.
"""

from __future__ import annotations

import torch

BLOCK_LEN = 8
BLOCK_VOLUME = BLOCK_LEN**3  # 512

KEY_BITS = 10
KEY_OFFSET = 1 << (KEY_BITS - 1)  # 512
KEY_MASK = (1 << KEY_BITS) - 1

INVALID_KEY = 0x7FFFFFFF

_FIB = 2654435769  # Fibonacci hashing multiplier, 2^32 / golden ratio


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


def voxel_offsets(device) -> torch.Tensor:
    """[512, 3] int32 intra-block voxel offsets, x-major (idx = x + 8y + 64z)."""
    idx = torch.arange(BLOCK_VOLUME, dtype=torch.int32, device=device)
    x = idx % BLOCK_LEN
    y = (idx // BLOCK_LEN) % BLOCK_LEN
    z = idx // (BLOCK_LEN * BLOCK_LEN)
    return torch.stack([x, y, z], dim=-1)
