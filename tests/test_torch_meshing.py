"""Meshing and the analytic map of the PyTorch port
(ra_slam_tpu_torch/map/meshing.py, synthetic_map.py) against the JAX
package's, on the CPU. Meshing reads the same map in both packages:
fused by JAX over the small orbit of tests/torch_parity.py and carried
into the port with `voxel_map_from_numpy`. The JAX side runs op by op."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from ra_slam_tpu.core.config import TsdfConfig as JaxTsdfConfig
from ra_slam_tpu.map import meshing as jme
from ra_slam_tpu.map import synthetic_map as jsm
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.eval.mesh_processor import MeshReader
from ra_slam_tpu_torch.map import meshing as tme
from ra_slam_tpu_torch.map import synthetic_map as tsm
from ra_slam_tpu_torch.map.voxel_map import create_map
from ra_slam_tpu_torch.utils.convert import voxel_map_from_numpy, voxel_map_to_numpy

# one u16 quantization step of the dump: positions per axis over the
# mesh's bounding box, probabilities over [0, 1]. Measured against JAX
# op by op: 0 steps for both (the same float32 operations in the same
# order, and the same last-use choice of a shared vertex's words).
U16_STEPS = 1.0


@pytest.fixture(scope="module")
def carried():
    jn, _ = tp.jax_fused_map(tp.jax_cfg())
    with jax.disable_jit():
        ref = jme.extract_mesh(jax.tree.map(jnp.asarray, jn), tp.jax_cfg())
    return voxel_map_from_numpy(jn, "cpu"), ref


def assert_mesh_matches(port, ref):
    """Counts and indices exact; vertices and probs within U16_STEPS."""
    (tv, ti, tpr), (jv, ji, jpr) = port, ref
    assert tv.shape == jv.shape and ti.shape == ji.shape and tpr.shape == jpr.shape
    np.testing.assert_array_equal(ti, ji)
    step = np.maximum(jv.max(0) - jv.min(0), 1e-9) / 65535.0
    assert (np.abs(tv - jv) / step).max() <= U16_STEPS * 1.001
    assert (np.abs(tpr - jpr) * 65535.0).max() <= U16_STEPS * 1.001


@pytest.mark.parametrize("chunk", [4096, 100])
def test_extract_mesh_matches_jax(carried, chunk):
    """The result does not depend on how the blocks are chunked."""
    tm, ref = carried
    out = tme.extract_mesh(tm, tp.torch_cfg(), chunk=chunk)
    assert len(ref[1]) > 10000  # a real surface
    assert_mesh_matches(out, ref)
    v, idx, _ = out
    assert idx.min() >= 0 and idx.max() < len(v)
    assert ((idx[:, 0] != idx[:, 1]) & (idx[:, 1] != idx[:, 2]) & (idx[:, 0] != idx[:, 2])).all()


def test_extract_mesh_empty_map():
    v, idx, p = tme.extract_mesh(create_map(tp.torch_cfg(), "cpu"), tp.torch_cfg())
    assert v.shape == (0, 3) and idx.shape == (0, 3) and p.shape == (0,)
    assert v.dtype == p.dtype == np.float32 and idx.dtype == np.int32


def test_extract_mesh_overflow_raises(carried):
    tm, ref = carried
    with pytest.raises(ValueError, match=f"has {len(ref[1])} triangles > max_tris=1000"):
        tme.extract_mesh(tm, tp.torch_cfg(), chunk=100, max_tris=1000)


def test_edge_key_orders_as_two_uint32_keys():
    """One int64 key per (hi, lo) pair sorts as JAX's two-key uint32
    sort: hi >= 2^31 (every non-negative lattice x) included, and the
    all-ones sentinel last."""
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 1 << 32, 5000, dtype=np.int64)
    lo = rng.integers(0, 1 << 32, 5000, dtype=np.int64)
    hi[:1000] = rng.integers(1 << 31, (1 << 31) + 4, 1000)  # many equal hi
    hi[-3:], lo[-3:] = 0xFFFFFFFF, 0xFFFFFFFF
    hi[5], lo[5] = 0xFFFFFFFF, 0xFFFFFFFE
    key = tme.edge_key(torch.as_tensor(hi), torch.as_tensor(lo))
    assert int(key[-1]) == torch.iinfo(torch.int64).max
    naive = torch.as_tensor((hi << 32) | lo)  # hi << 32 | lo wraps negative
    assert (naive < 0).any()
    order = torch.argsort(key, stable=True).numpy()
    np.testing.assert_array_equal(order, np.lexsort((lo, hi)))
    np.testing.assert_array_equal(order[-3:], [4997, 4998, 4999])


@pytest.mark.parametrize("seed", range(8))
def test_select_sum_luts_equal_indexing(seed):
    """The JAX package's select-sum table lookups equal
    `take_along_axis`, and the port's plain indexing equals both."""
    rng = np.random.default_rng(seed)
    shape = tuple(rng.integers(1, 5, rng.integers(1, 4)))
    C = int(rng.integers(2, 9))
    vals = rng.standard_normal(shape + (C,)).astype(np.float32)
    ids = rng.integers(0, C, int(rng.integers(1, 7))).astype(np.int32)
    sel = np.asarray(jme._sel_columns(jnp.asarray(vals), jnp.asarray(ids)))
    tal = np.take_along_axis(vals, np.broadcast_to(ids, shape + ids.shape), axis=-1)
    np.testing.assert_array_equal(sel, tal)
    np.testing.assert_array_equal(torch.as_tensor(vals)[..., torch.as_tensor(ids).long()].numpy(), tal)

    table = rng.integers(-1, 6, (int(rng.integers(2, 17)), int(rng.integers(1, 7)))).astype(np.int32)
    case = rng.integers(0, table.shape[0], shape).astype(np.int32)
    rows = np.asarray(jme._sel_rows(jnp.asarray(case), jnp.asarray(table)))
    tal = np.take_along_axis(table[None], case.reshape(-1, 1, 1), axis=1).reshape(shape + table.shape[1:])
    np.testing.assert_array_equal(rows, tal)
    np.testing.assert_array_equal(torch.as_tensor(table)[torch.as_tensor(case).long()].numpy(), tal)


def test_save_mesh_round_trip(carried, tmp_path):
    """The three `.bin` dumps read back bit for bit, by numpy and by the
    port's MeshReader."""
    v, idx, p = tme.extract_mesh(carried[0], tp.torch_cfg())
    paths = [str(tmp_path / n) for n in ("mesh_vertices.bin", "mesh_indices.bin", "mesh_vertices_prob.bin")]
    tme.save_mesh(v, idx, p, *paths)
    np.testing.assert_array_equal(np.fromfile(paths[0], np.float32).reshape(-1, 3), v)
    np.testing.assert_array_equal(np.fromfile(paths[1], np.int32).reshape(-1, 3), idx)
    np.testing.assert_array_equal(np.fromfile(paths[2], np.float32), p)
    r = MeshReader(str(tmp_path))
    assert r.num_vertices() == len(v) and r.num_triangles() == len(idx)
    np.testing.assert_array_equal(r.ht_prob, p)


def test_analytic_box_map_matches_jax():
    """Metadata, table and free stack exactly, payload within 1e-6
    (measured 0); and its mesh lies on the room's walls."""
    kw = dict(voxel_size=0.1, truncation=0.3, log2_num_blocks=12, log2_hash_size=14,
              max_visible_blocks=2048, width=160, height=120)
    he = (1.5, 1.0, 1.5)
    jn = jax.tree.map(np.asarray, jsm.analytic_box_map(JaxTsdfConfig(**kw), half_extents=he))
    cfg = TsdfConfig(**kw)
    tm = tsm.analytic_box_map(cfg, "cpu", half_extents=he)
    tp.assert_maps_match(jn, voxel_map_to_numpy(tm), tol={"tsdf": 1e-6, "weight": 1e-6, "prob": 1e-6})
    assert int(tm.active.sum()) > 100

    v, idx, _ = tme.extract_mesh(tm, cfg)
    wall_d = np.min(np.abs(np.abs(v) - np.array(he)[None]), axis=1)
    assert len(idx) > 1000 and np.percentile(wall_d, 95) < 0.5 * cfg.voxel_size


def test_analytic_box_map_overflow_raises():
    cfg = dataclasses.replace(TsdfConfig(voxel_size=0.1, truncation=0.3), log2_num_blocks=6)
    with pytest.raises(ValueError, match="overflowed the pool"):
        tsm.analytic_box_map(cfg, "cpu", half_extents=(1.5, 1.0, 1.5))
