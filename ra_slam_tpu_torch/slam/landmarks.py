"""Fixed-capacity 3-D landmark (map point) store (counterpart of
`ra_slam_tpu/slam/landmarks.py`).

Insertion takes free slots in rank order (the i-th inserted row gets the
i-th free slot), so the port fills the same slots as the JAX package.
Updates are functional: each returns a new `Landmarks`.

The JAX package's `.at[idx].set(v, mode="drop")` becomes a scatter into
a copy with one sentinel row, where the dropped writes land; the copy
loses the row after. No boolean-mask indexing, so nothing waits for the
device. Where an index repeats, the last write wins, as XLA's CPU
scatter orders them (the CUDA scatter promises no order, so the losers
are sent to the sentinel row first).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class Landmarks:
    pos: torch.Tensor  # [M, 3] float32 world position
    desc: torch.Tensor  # [M, 8] int32 representative ORB descriptor
    valid: torch.Tensor  # [M] bool
    n_obs: torch.Tensor  # [M] int32 times observed (matched as inlier)
    last_seen: torch.Tensor  # [M] int32 keyframe counter at last inlier match
    anchor: torch.Tensor  # [M] int32 keyframe counter at creation

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def create_landmarks(capacity: int, device) -> Landmarks:
    z = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device=device)
    return Landmarks(
        pos=z(capacity, 3, dt=torch.float32),
        desc=z(capacity, 8),
        valid=z(capacity, dt=torch.bool),
        n_obs=z(capacity),
        last_seen=z(capacity),
        anchor=z(capacity),
    )


def _last_writer(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[K] bool: write k is the last one to index idx[k] (< n)."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n + 1,), -1, dtype=pos.dtype, device=idx.device)
    last = last.scatter_reduce(0, idx, pos, "amax")
    return last[idx] == pos


def scatter_rows(x: torch.Tensor, idx: torch.Tensor, vals, keep: torch.Tensor) -> torch.Tensor:
    """A copy of x [N, ...] with rows idx[k] set to vals[k] (a tensor of
    rows or a scalar) where keep[k]; the last write to a row wins."""
    n = x.shape[0]
    widx = torch.where(keep & (idx >= 0) & (idx < n), idx, n).long()
    widx = torch.where(_last_writer(widx, n), widx, n)
    ext = torch.cat([x, x[:1]])
    if not torch.is_tensor(vals):
        vals = torch.tensor(vals, dtype=x.dtype, device=x.device)
    ext.index_put_((widx,), vals.to(x.dtype).expand(idx.shape[0], *x.shape[1:]))
    return ext[:n]


def add_rows(x: torch.Tensor, idx: torch.Tensor, val: int, keep: torch.Tensor) -> torch.Tensor:
    """A copy of x [N] with `val` added at idx[k] for each k with keep[k]
    (repeats add up)."""
    n = x.shape[0]
    widx = torch.where(keep & (idx >= 0) & (idx < n), idx, n).long()
    ext = torch.cat([x, x[:1]])
    ones = torch.full(idx.shape, val, dtype=x.dtype, device=x.device)
    ext.index_put_((widx,), ones, accumulate=True)
    return ext[:n]


def add_landmarks(
    lms: Landmarks,
    pos: torch.Tensor,  # [K, 3]
    desc: torch.Tensor,  # [K, 8]
    mask: torch.Tensor,  # [K] bool rows to insert
    kf_counter: torch.Tensor,  # int32 scalar
) -> Tuple[Landmarks, torch.Tensor]:
    """Insert up to K new landmarks into free slots. Returns (new store,
    slot indices [K] int32, -1 where not inserted)."""
    M = lms.capacity
    K = pos.shape[0]
    dev = pos.device
    free = ~lms.valid
    rank = torch.cumsum(free.to(torch.int64), 0) - 1  # rank among free slots
    # slot of the j-th inserted row = index of the j-th free slot
    freelist = scatter_rows(
        torch.full((K,), -1, dtype=torch.int64, device=dev),
        rank, torch.arange(M, device=dev), free & (rank < K),
    )
    order = torch.cumsum(mask.to(torch.int64), 0) - 1  # insertion order of row j
    slot = torch.where(mask, freelist[torch.clamp(order, 0, K - 1)], -1)
    ok = mask & (slot >= 0)
    new = Landmarks(
        pos=scatter_rows(lms.pos, slot, pos, ok),
        desc=scatter_rows(lms.desc, slot, desc, ok),
        valid=scatter_rows(lms.valid, slot, True, ok),
        n_obs=scatter_rows(lms.n_obs, slot, 1, ok),
        last_seen=scatter_rows(lms.last_seen, slot, kf_counter, ok),
        anchor=scatter_rows(lms.anchor, slot, kf_counter, ok),
    )
    return new, torch.where(ok, slot, -1).to(torch.int32)


def record_observations(
    lms: Landmarks, lm_idx: torch.Tensor, mask: torch.Tensor, kf_counter: torch.Tensor
) -> Landmarks:
    """Bump n_obs/last_seen of the landmarks matched as inliers."""
    keep = mask & (lm_idx >= 0)
    return dataclasses.replace(
        lms,
        n_obs=add_rows(lms.n_obs, lm_idx, 1, keep),
        last_seen=scatter_rows(lms.last_seen, lm_idx, kf_counter, keep),
    )


def cull_landmarks(
    lms: Landmarks, kf_counter: torch.Tensor, min_obs: int = 2, max_age: int = 30
) -> Landmarks:
    """Invalidate landmarks that are both rarely observed and stale."""
    stale = (kf_counter - lms.last_seen) > max_age
    weak = lms.n_obs < min_obs
    return dataclasses.replace(lms, valid=lms.valid & ~(stale & weak))


def num_valid(lms: Landmarks) -> torch.Tensor:
    return lms.valid.sum(dtype=torch.int32)
