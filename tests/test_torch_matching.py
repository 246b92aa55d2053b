"""Descriptor matching of the PyTorch port against the JAX package on the
CPU: the Hamming matrix's plain version (what the CUDA kernel is held
to on the card) against `hamming_matrix_popcount` and the Pallas kernel
in interpret mode, and the matchers, exactly. Descriptors cross as
numpy: the JAX package's uint32 words viewed as int32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.features import matching as jm
from ra_slam_tpu.ops.hamming import hamming_matrix_pallas
from ra_slam_tpu_torch.features import matching as tm
from ra_slam_tpu_torch.ops import hamming as th


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.mark.parametrize("ka,kb", [(1, 1), (130, 300), (300, 130), (257, 511), (64, 128)])
def test_hamming_plain_equals_popcount_and_pallas(ka, kb):
    rng = np.random.default_rng(ka * 1000 + kb)
    a, b = _desc(rng, ka), _desc(rng, kb)
    b[0] = a[0]  # distance 0
    a[-1] = ~b[-1]  # distance 256
    ref = np.asarray(jm.hamming_matrix_popcount(jnp.asarray(a), jnp.asarray(b)))
    pal = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    out = th.hamming_matrix_plain(_t(a), _t(b))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), pal)
    # the dispatching entry point runs the plain version on CPU tensors
    # and launches nothing
    n0 = th.LAUNCHES
    np.testing.assert_array_equal(tm.hamming_matrix(_t(a), _t(b)).numpy(), ref)
    assert th.LAUNCHES == n0


@pytest.mark.parametrize("ka,kb", [(1, 1), (130, 300), (0, 7), (257, 511)])
def test_hamming_matrix_popcount_matches_jax(ka, kb):
    """Exact int32 integers, through the port's Hamming function (the
    plain version on CPU tensors; the kernel on the card)."""
    rng = np.random.default_rng(ka * 7 + kb)
    a, b = _desc(rng, ka), _desc(rng, kb)
    if ka:
        b[0] = a[0]
    ref = np.asarray(jm.hamming_matrix_popcount(jnp.asarray(a), jnp.asarray(b)))
    out = tm.hamming_matrix_popcount(_t(a), _t(b))
    assert out.dtype == torch.int32 and out.shape == (ka, kb)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("ka,kb", [(1, 1), (130, 300), (300, 130), (257, 511), (64, 128)])
def test_pm1_product_identity(ka, kb):
    """The identities the CUDA kernel and the library yardstick of
    scripts/bench_torch_kernels.py rely on, exactly: (256 - pm1(a) @
    pm1(b)^T) / 2, in int32
    from the port's unpack_pm1 (the yardstick), and popc(a) + popc(b) -
    2 popc(a & b) summed over the words (the kernel's binary tensor-core
    product) both equal the popcount distances and the JAX package's
    route off the TPU."""
    rng = np.random.default_rng(ka * 1000 + kb + 1)
    a, b = _desc(rng, ka), _desc(rng, kb)
    b[0] = a[0]  # distance 0
    a[-1] = ~b[-1]  # distance 256
    ta, tb = _t(a), _t(b)
    pa, pb = tm.unpack_pm1(ta).to(torch.int32), tm.unpack_pm1(tb).to(torch.int32)
    dot = pa @ pb.T
    assert ((256 - dot) % 2 == 0).all()
    dist = ((256 - dot) // 2).numpy()
    popc = lambda x: th._popcount32(x).sum(-1)
    both = sum(th._popcount32(ta[:, w, None] & tb[None, :, w]) for w in range(th.WORDS))
    np.testing.assert_array_equal((popc(ta)[:, None] + popc(tb)[None, :] - 2 * both).numpy(), dist)
    np.testing.assert_array_equal(dist, th.hamming_matrix_plain(ta, tb).numpy())
    np.testing.assert_array_equal(dist, np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    assert dist[-1, -1] == 256 and dist.min() == (0 if ka * kb > 1 else 256)


@pytest.mark.parametrize("ka,kb", [(0, 5), (5, 0), (0, 0)])
def test_hamming_empty_sides(ka, kb):
    rng = np.random.default_rng(1)
    a, b = _desc(rng, ka), _desc(rng, kb)
    ref = np.asarray(jm.hamming_matrix_popcount(jnp.asarray(a), jnp.asarray(b)))
    out = th.hamming_matrix_plain(_t(a), _t(b))
    assert out.shape == ref.shape == (ka, kb)


def test_hamming_rejects_other_devices():
    a = torch.zeros(3, 8, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        th.hamming_matrix(a, a)


def test_unpack_pm1_matches_jax():
    d = _desc(np.random.default_rng(2), 9)
    np.testing.assert_array_equal(tm.unpack_pm1(_t(d)).numpy(), np.asarray(jm.unpack_pm1(jnp.asarray(d))))


def _tied_sets(seed: int):
    """Query and target descriptors with many tied distances: targets are
    few distinct words repeated, queries are targets with a few bits
    flipped."""
    rng = np.random.default_rng(seed)
    base = _desc(rng, 12)
    b = base[rng.integers(0, 12, 200)]
    a = base[rng.integers(0, 12, 90)].copy()
    flips = rng.integers(0, 32, (90, 8))
    a ^= (rng.random((90, 8)) < 0.3).astype(np.uint32) << flips.astype(np.uint32)
    va = rng.random(90) < 0.9
    vb = rng.random(200) < 0.8
    return a, va, b, vb


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_d,ratio", [(64.0, 0.8), (140.0, 1.01), (256.0, 0.95)])
def test_match_and_mutual_match_exact(seed, max_d, ratio):
    """idx, dist and valid equal JAX's, ties included: the best is the
    first minimum, as `jax.lax.top_k` orders ties."""
    a, va, b, vb = _tied_sets(seed)
    ja = (jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb))
    ta = (_t(a), torch.from_numpy(va), _t(b), torch.from_numpy(vb))
    with jax.disable_jit():
        refs = (jm.match_descriptors(*ja, max_d, ratio), jm.mutual_match(*ja, max_d, ratio))
    outs = (tm.match_descriptors(*ta, max_d, ratio), tm.mutual_match(*ta, max_d, ratio))
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(out.dist.numpy(), np.asarray(ref.dist))
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    # the inputs do hold ties at the best distance
    d = th.hamming_matrix_plain(ta[0], ta[2]).numpy()
    d[:, ~vb] = np.inf
    assert ((d == d.min(axis=1, keepdims=True)).sum(axis=1) > 1).any()
