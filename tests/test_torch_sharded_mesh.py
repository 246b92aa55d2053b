"""The halo-exchange export of the PyTorch port's sharded map
(ra_slam_tpu_torch/parallel/sharded_map.py: `make_halo_augment`,
`extract_mesh_sharded` in both modes, and the budgeted emission of
ra_slam_tpu_torch/map/meshing.py) against the JAX package's on the CPU.

Four slab shards (`owner_mode="slab"`, `cell_log2=1`) fuse
tests/test_sharded_map.py's three halo-test frames in both packages, the
JAX side op by op (tests/test_torch_sharded_map.py says how); JAX's
augment and mesher then run jitted on JAX's shards, the port's on its
own. The augment moves data and computes none, so its rows equal JAX's
exactly (payload within TOL, as the shards'); the meshes hold the same
triangles, their vertices within one u16 quantization step of each
shard's bounding box.
"""

import functools

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from scipy.spatial import cKDTree

import torch_parity as tp
from test_sharded_map import _cfg
from test_torch_sharded_map import (
    assert_shards_match,
    frames,
    global_from_stacked,
    jax_sharded_op_by_op,
    jax_shard,
    port_cfg,
    port_sharded,
    slab_poses,
    stacked_from_global,
)
from ra_slam_tpu.parallel import sharded_map as jsm
from ra_slam_tpu_torch.map.meshing import extract_mesh
from ra_slam_tpu_torch.parallel import make_gather_shards
from ra_slam_tpu_torch.parallel.sharded_map import extract_mesh_sharded, make_halo_augment
from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy

N_SHARDS, CELL_LOG2, MIN_WEIGHT = 4, 1, 1.0


@functools.lru_cache()
def _slab_run():
    jcfg = _cfg()
    fr = frames([slab_poses(k) for k in range(3)])
    kw = dict(alloc_stride=2, carve=True, owner_mode="slab", cell_log2=CELL_LOG2)
    j, jstats = jax_sharded_op_by_op(jcfg, N_SHARDS, [a for a, _ in fr], **kw)
    mesh, shards, stats = port_sharded(port_cfg(jcfg), N_SHARDS, [b for _, b in fr], **kw)
    jmesh = Mesh(np.array(jax.devices()[:N_SHARDS]), ("map",))
    return jcfg, j, jstats, jmesh, mesh, shards, stats


def test_slab_fusion_matches_jax_shard_by_shard():
    """4 slab shards: every shard exactly as JAX's op-by-op shard body
    (keys, table, free stack, counters; payload within TOL)."""
    _, j, jstats, _, _, shards, stats = _slab_run()
    assert stats == jstats and stats[-1]["alloc_failures"] == 0
    assert_shards_match(j, shards)
    # every shard owns part of the surface
    assert all(int(s.active.sum()) > 0 for s in shards)


def test_halo_augment_matches_jax():
    """The augmented shards: halo rows in the same pool rows with the
    same keys and table slots as JAX's, inactive; the shards themselves
    unchanged; the same dropped count."""
    jcfg, j, _, jmesh, mesh, shards, _ = _slab_run()
    before = [voxel_map_to_numpy(s) for s in shards]
    jaug, jdropped = jsm.make_halo_augment(jmesh, jcfg, cell_log2=CELL_LOG2)[0](global_from_stacked(j))
    aug, dropped = make_halo_augment(mesh, port_cfg(jcfg), cell_log2=CELL_LOG2)[0](shards)
    assert int(dropped) == int(jdropped) == 0
    ja = stacked_from_global(jax.device_get(jaug), N_SHARDS)
    halo_rows = 0
    for i, a in enumerate(aug):
        tp.assert_maps_match(jax_shard(ja, i), voxel_map_to_numpy(a))
        halo_rows += int(((a.block_key != 0x7FFFFFFF) & ~a.active).sum())
        b = before[i]
        np.testing.assert_array_equal(voxel_map_to_numpy(shards[i]).block_key, b.block_key)
    assert halo_rows > 0


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_extract_mesh_sharded_matches_jax(mode):
    """Both modes against JAX's parallel sharded mesher: the same
    triangles in the same order, vertices within one u16 step of the
    shard's bounding box, probabilities within one step, the same stats
    (per-shard triangle counts in parallel mode); the mesh of the
    gathered map holds the same triangle soup (centroids within 1 mm
    both ways, as tests/test_sharded_map.py), and each shard held less
    than half the map."""
    jcfg, j, _, jmesh, mesh, shards, stats = _slab_run()
    cfg = port_cfg(jcfg)
    jv, jt, jp, jinfo = jsm.extract_mesh_sharded(global_from_stacked(j), jmesh, jcfg, cell_log2=CELL_LOG2,
                                                 min_weight=MIN_WEIGHT)
    v, t, p, info = extract_mesh_sharded(shards, mesh, cfg, cell_log2=CELL_LOG2, min_weight=MIN_WEIGHT, mode=mode)
    assert len(t) == len(jt) > 100 and len(v) == len(jv)
    np.testing.assert_array_equal(t, jt)
    step = (jv.max(0) - jv.min(0)) / 65535.0
    assert (np.abs(v - jv) <= step * 1.001 + 1e-6).all(), np.abs(v - jv).max(0)
    assert np.abs(p - jp).max() <= 1.001 / 65535.0
    want = jinfo if mode == "parallel" else {k: jinfo[k] for k in ("dropped", "peak_blocks_per_shard")}
    assert info == want

    gather, gcfg = make_gather_shards(mesh, cfg)
    g, _ = gather(shards)
    vg, tg, _ = extract_mesh(g, gcfg, min_weight=MIN_WEIGHT)
    assert len(tg) == len(t)
    c_s, c_g = v[t].mean(axis=1), vg[tg].mean(axis=1)
    assert cKDTree(c_g).query(c_s)[0].max() < 1e-3 and cKDTree(c_s).query(c_g)[0].max() < 1e-3
    # JAX's test asks < 0.45 of the map at 8 shards; 4 shards hold < 0.5
    assert info["peak_blocks_per_shard"] < 0.5 * stats[-1]["num_active"]


def test_mesh_budget_overflow_raises_in_both():
    """A per-shard budget below the surface raises ValueError naming the
    per-shard drops, in both packages."""
    jcfg, j, _, jmesh, mesh, shards, _ = _slab_run()
    with pytest.raises(ValueError, match="sharded mesh overflow"):
        jsm.extract_mesh_sharded(global_from_stacked(j), jmesh, jcfg, cell_log2=CELL_LOG2, min_weight=MIN_WEIGHT,
                                 cap_shard=64)
    with pytest.raises(ValueError, match=r"sharded mesh overflow \(per-shard drops \[\d+, \d+, \d+, \d+\]\)"):
        extract_mesh_sharded(shards, mesh, port_cfg(jcfg), cell_log2=CELL_LOG2, min_weight=MIN_WEIGHT,
                             cap_shard=64)
