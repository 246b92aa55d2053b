"""Binary descriptor matching (counterpart of
`ra_slam_tpu/features/matching.py`).

The distance matrix is exact XOR + popcount: the CUDA kernel on the card
(`ops/hamming.py`), its plain version on the CPU. The JAX package's
other route off the TPU, a ±1-vector matrix product, gives the same
integers and is not ported.

Best/second-best search keeps `jax.lax.top_k`'s tie order: the best is
the first minimum (`argmin`), the second the minimum with that one
column masked.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ra_slam_tpu_torch.features.orb import DESC_WORDS, NUM_PAIRS  # noqa: F401  (re-exports DESC_WORDS, as JAX does)
from ra_slam_tpu_torch.ops.hamming import hamming_matrix


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[K, 8] int32 words -> [K, 256] float32 in {-1, +1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], NUM_PAIRS).to(torch.float32) * 2.0 - 1.0


def hamming_matrix_popcount(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Exact integer Hamming matrix [Ka, Kb] int32 (XOR + popcount:
    the kernel on the card, its plain version on the CPU)."""
    return hamming_matrix(desc_a, desc_b).to(torch.int32)


@dataclass(frozen=True)
class Matches:
    """For every query keypoint, its best target."""

    idx: torch.Tensor  # [Ka] int32 best match in b (always set)
    dist: torch.Tensor  # [Ka] float32 best Hamming distance
    valid: torch.Tensor  # [Ka] bool passed ratio/threshold tests


def best_two(d: torch.Tensor):
    """(best [F], first argmin [F] int64, second best [F]) along dim 1."""
    best = d.amin(dim=1)
    bidx = torch.argmin(d, dim=1)  # the first minimum, as jnp.argmin
    second = d.scatter(1, bidx[:, None], float("inf")).amin(dim=1)
    return best, bidx, second


def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    max_distance: float = 64.0,
    ratio: float = 0.8,
) -> Matches:
    """Best match with Lowe's ratio test (best < ratio * second-best)."""
    d = torch.where(valid_b[None, :], hamming_matrix(desc_a, desc_b), float("inf"))
    best, bidx, second = best_two(d)
    ok = (
        valid_a
        & (best <= max_distance)
        & (best < ratio * torch.clamp(second, max=float(NUM_PAIRS)))
    )
    return Matches(idx=bidx.to(torch.int32), dist=best, valid=ok)


def mutual_match(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    max_distance: float = 64.0,
    ratio: float = 0.8,
) -> Matches:
    """Cross-check matching: a->b and b->a must agree."""
    m_ab = match_descriptors(desc_a, valid_a, desc_b, valid_b, max_distance, ratio)
    m_ba = match_descriptors(desc_b, valid_b, desc_a, valid_a, max_distance, ratio)
    back = m_ba.idx[m_ab.idx.long()]
    agree = back == torch.arange(desc_a.shape[0], dtype=torch.int32, device=desc_a.device)
    return Matches(idx=m_ab.idx, dist=m_ab.dist, valid=m_ab.valid & agree)
