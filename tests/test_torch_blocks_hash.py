"""Block keys and the spatial hash: the PyTorch port against the JAX
package, bit for bit (ra_slam_tpu_torch/map/blocks.py, hash_table.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.map import blocks as jb
from ra_slam_tpu.map import hash_table as jh
from ra_slam_tpu_torch.map import blocks as tb
from ra_slam_tpu_torch.map import hash_table as th


def _coords(rng, n=4000):
    # in range, out of range on one axis, and far out of range
    c = rng.integers(-520, 520, (n, 3)).astype(np.int32)
    c[: n // 8] = rng.integers(-2_000_000, 2_000_000, (n // 8, 3))
    return c


def test_pack_unpack_exact():
    rng = np.random.default_rng(0)
    c = _coords(rng)
    kj = np.asarray(jb.pack_block_coords(jnp.asarray(c)))
    kt = tb.pack_block_coords(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(kj, kt)
    assert (kj == jb.INVALID_KEY).sum() > len(c) // 8  # out-of-range cases hit
    np.testing.assert_array_equal(
        np.asarray(jb.unpack_block_coords(jnp.asarray(kj))),
        tb.unpack_block_coords(torch.tensor(kj)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jb.voxel_offsets()), tb.voxel_offsets("cpu").numpy()
    )


@pytest.mark.parametrize("log2_size", [4, 10, 15, 19])
def test_hash_key_exact(log2_size):
    rng = np.random.default_rng(log2_size)
    keys = rng.integers(-(2**31), 2**31, 5000, dtype=np.int64).astype(np.int32)
    keys[:10] = jb.INVALID_KEY
    keys[10:20] = [0, 1, -1, 2**31 - 2, -(2**31), 512, 1 << 20, 7, 8, 9]
    hj = np.asarray(jb.hash_key(jnp.asarray(keys), log2_size))
    ht = tb.hash_key(torch.from_numpy(keys), log2_size).numpy()
    np.testing.assert_array_equal(hj, ht)
    assert ht.min() >= 0 and ht.max() < (1 << log2_size)


def test_hash_table_batches_exact():
    """Several insert/lookup/remove rounds on a 4-bucket table, driven
    until buckets are full so inserts fail: table arrays, slots and
    placed equal the JAX package's after every call."""
    rng = np.random.default_rng(1)
    jt = jh.HashTable.create(6)  # 64 slots = 4 buckets of 16
    tt = th.HashTable.create(6, "cpu")
    present = []
    n_failed = 0
    for round_ in range(6):
        pool = rng.choice(2**24, 200, replace=False).astype(np.int32)
        fresh = np.array([k for k in pool if k not in present][:24], np.int32)
        vals = rng.integers(0, 1000, len(fresh)).astype(np.int32)
        valid = rng.random(len(fresh)) < 0.85
        jt, sj, pj = jh.ht_insert(jt, jnp.asarray(fresh), jnp.asarray(vals), jnp.asarray(valid))
        st, pt = th.ht_insert(tt, torch.from_numpy(fresh), torch.from_numpy(vals), torch.from_numpy(valid))
        np.testing.assert_array_equal(np.asarray(sj), st.numpy())
        np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
        np.testing.assert_array_equal(np.asarray(jt.key), tt.key.numpy())
        np.testing.assert_array_equal(np.asarray(jt.value), tt.value.numpy())
        n_failed += int((valid & ~pt.numpy()).sum())
        present += fresh[pt.numpy()].tolist()

        queries = np.concatenate([fresh, pool[-20:], [jb.INVALID_KEY]]).astype(np.int32)
        np.testing.assert_array_equal(
            np.asarray(jh.ht_lookup(jt, jnp.asarray(queries))),
            th.ht_lookup(tt, torch.from_numpy(queries)).numpy(),
        )

        if round_ % 2 == 1:  # free some slots so later rounds refill them
            rm = pt.numpy() & (rng.random(len(fresh)) < 0.5)
            jt = jh.ht_remove(jt, sj, jnp.asarray(rm))
            th.ht_remove(tt, st, torch.from_numpy(rm))
            present = [k for k in present if k not in set(fresh[rm].tolist())]
            np.testing.assert_array_equal(np.asarray(jt.key), tt.key.numpy())
            np.testing.assert_array_equal(np.asarray(jt.value), tt.value.numpy())
    assert n_failed > 0  # full buckets were reached


def test_point_to_block_and_world_to_voxel_exact():
    rng = np.random.default_rng(3)
    vox = rng.integers(-5000, 5000, (4000, 3)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jb.point_to_block(jnp.asarray(vox))),
                                  tb.point_to_block(torch.from_numpy(vox)).numpy())
    pts = rng.uniform(-20, 20, (4000, 3)).astype(np.float32)
    pts[:40] = np.round(pts[:40] / 0.04) * 0.04  # on voxel faces
    pts[40:44] = [[1e12, -1e12, np.nan]] * 4  # saturating casts
    for vs in (0.01, 0.04):
        ref = np.asarray(jb.world_to_voxel(jnp.asarray(pts), vs))
        out = tb.world_to_voxel(torch.from_numpy(pts), vs)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)
