"""The dense census stereo's work, counted from its shapes and not from
any one implementation's arrays (`reference/dense_stereo.py` states the
algorithm), so that the eager program of today and a CUDA kernel of
tomorrow are read against the same work.

For one rectified pair of H x W gray images at D disparities:
- bytes: the two gray images read (float32) and the depth (float32) and
  its validity (one byte) written;
- operations, per cost-volume entry (H W D): one xor, one popcount, the
  separable box sums' 2 (block - 1) adds, and the selection's three
  reductions over d (the best, the best away from +-1, the right view's
  best).

Peaks: NVIDIA's H100 SXM data sheet at 700 W: 3.35 TB/s of HBM, 66.9
TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

from benchmark.harness.work import HBM_BYTES_PER_S

FP32_OPS_PER_S = 66.9e12
SELECT_REDUCTIONS = 3


def dense_bytes(height: int, width: int) -> int:
    return height * width * (4 + 4 + 4 + 1)


def dense_ops(height: int, width: int, disparities: int, block: int) -> int:
    return height * width * disparities * (2 + 2 * (block - 1) + SELECT_REDUCTIONS)


def least_seconds(height: int, width: int, disparities: int, block: int) -> float:
    """The least time of one pair on the card: the larger of its bytes
    over the memory's bandwidth and its operations over the float32 peak."""
    return max(dense_bytes(height, width) / HBM_BYTES_PER_S,
               dense_ops(height, width, disparities, block) / FP32_OPS_PER_S)
