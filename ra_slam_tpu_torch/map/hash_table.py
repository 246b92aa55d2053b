"""Bucket-aligned spatial hash table on tensors (counterpart of
`ra_slam_tpu/map/hash_table.py`).

2^(log2_size-4) aligned buckets of 16 slots. A lookup compares a key
against its whole bucket; deletion needs no tombstones. Insertion is the
JAX package's deterministic rank protocol: sort the batch by bucket
(stable, so ties keep batch order), give each key its rank among
same-bucket keys, and hand it the (rank+1)-th empty slot of its bucket.
Distinct keys never collide, and a key fails only when its bucket is
full. The slot every key lands in equals the JAX package's bit for bit.

`ht_insert` and `ht_remove` update the table in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ra_slam_tpu_torch.map.blocks import INVALID_KEY, hash_key

BUCKET_LOG2 = 4
BUCKET = 1 << BUCKET_LOG2  # 16 slots per bucket


@dataclass
class HashTable:
    """key[T] (INVALID_KEY = empty) and value[T] (pool block index),
    T = 2^log2_size slots, int32."""

    key: torch.Tensor
    value: torch.Tensor

    @property
    def log2_size(self) -> int:
        return self.key.shape[0].bit_length() - 1

    @property
    def num_buckets(self) -> int:
        return self.key.shape[0] >> BUCKET_LOG2

    @staticmethod
    def create(log2_size: int, device) -> "HashTable":
        if log2_size < BUCKET_LOG2:
            raise ValueError(f"log2_size must be >= {BUCKET_LOG2}")
        size = 1 << log2_size
        return HashTable(
            key=torch.full((size,), INVALID_KEY, dtype=torch.int32, device=device),
            value=torch.full((size,), -1, dtype=torch.int32, device=device),
        )


def _bucket_of(table: HashTable, keys: torch.Tensor) -> torch.Tensor:
    return hash_key(keys, table.log2_size - BUCKET_LOG2)


def ht_lookup(table: HashTable, keys: torch.Tensor) -> torch.Tensor:
    """Batched lookup: keys [Q] int32 -> block index [Q] (-1 = not found)."""
    b = _bucket_of(table, keys).long()
    row_k = table.key.view(-1, BUCKET)[b]  # [Q, 16]
    row_v = table.value.view(-1, BUCKET)[b]
    match = (row_k == keys[:, None]) & (keys != INVALID_KEY)[:, None]
    return torch.where(match, row_v, -1).amax(dim=-1)


def ht_insert(
    table: HashTable,
    keys: torch.Tensor,
    values: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched insert of (key, value) pairs, in place.

    Args:
      keys:   [K] int32, unique among valid entries and not already in
              the table (dedup + lookup first).
      values: [K] int32 pool indices to store.
      valid:  [K] bool entries to insert.

    Returns (slots [K] int32, -1 where not placed; placed [K] bool).
    """
    K = keys.shape[0]
    B = table.num_buckets
    dev = keys.device

    # sort by bucket (invalid entries to sentinel bucket B), stable so the
    # permutation carries the batch position as the tie-break
    b = torch.where(valid, _bucket_of(table, keys), B)
    sb, sid = torch.sort(b, stable=True)

    # within-bucket rank
    pos = torch.arange(K, dtype=torch.int64, device=dev)
    seg_start = torch.ones(K, dtype=torch.bool, device=dev)
    seg_start[1:] = sb[1:] != sb[:-1]
    start_idx = torch.cummax(torch.where(seg_start, pos, 0), dim=0).values
    rank = pos - start_idx

    # each key takes the (rank+1)-th empty slot of its bucket
    row_k = table.key.view(-1, BUCKET)[torch.clamp(sb, max=B - 1).long()]  # [K, 16]
    empty = row_k == INVALID_KEY
    n_empty_sofar = torch.cumsum(empty.to(torch.int32), dim=-1)
    hit = empty & (n_empty_sofar == (rank + 1)[:, None])
    placed_s = hit.any(dim=-1) & (sb < B)
    slot_s = torch.where(
        placed_s,
        (sb << BUCKET_LOG2) + torch.argmax(hit.to(torch.int32), dim=-1).to(torch.int32),
        -1,
    ).to(torch.int32)

    # conflict-free writes: distinct slots by construction
    w = slot_s[placed_s].long()
    table.key[w] = keys[sid][placed_s]
    table.value[w] = values[sid][placed_s]

    # un-sort back to batch order (sid is a permutation)
    slots = torch.empty(K, dtype=torch.int32, device=dev)
    slots[sid] = slot_s
    placed = torch.empty(K, dtype=torch.bool, device=dev)
    placed[sid] = placed_s
    return slots, placed


def ht_remove(table: HashTable, slots: torch.Tensor, mask: torch.Tensor) -> None:
    """Clear table entries at `slots` [K] where mask [K] is set, in place."""
    idx = slots[mask].long()
    table.key[idx] = INVALID_KEY
    table.value[idx] = -1
