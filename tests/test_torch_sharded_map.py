"""The sharded map of the PyTorch port (ra_slam_tpu_torch/parallel/
sharded_map.py) against the JAX package's on the CPU: shard ownership,
the per-shard configuration, sharded fusion on `LocalMesh` shards, and
the gather export.

The JAX reference is JAX's own shard body (`_sharded_integrate_frame`)
run op by op: under `jax.disable_jit()` the shards are stacked on a
`vmap` axis named "map", which serves the body's `axis_index` and
`psum` (through `jax.shard_map` op by op the same frame takes minutes).
Op by op, every shard's keys, table, free stack and counters equal the
port's exactly and its payload is within tests/torch_parity.py's TOL.
The jitted `shard_map` step (XLA's CPU backend contracts multiply-adds,
tests/torch_parity.py) allocates the same blocks, table slots and free
stacks; its payload differs from the op-by-op one in voxels whose pixel
choice flips, and the count is printed.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parity as tp
from test_sharded_map import _cfg, _frame
from ra_slam_tpu.core.se3 import SE3 as JaxSE3
from ra_slam_tpu.map import blocks as jblocks
from ra_slam_tpu.map import voxel_map as jvm
from ra_slam_tpu.parallel import sharded_map as jsm
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.map import blocks as tblocks
from ra_slam_tpu_torch.map import voxel_map as tvm
from ra_slam_tpu_torch.parallel import (
    LocalMesh,
    create_sharded_map,
    local_config,
    make_gather_shards,
    make_sharded_integrate_step,
    map_partition_specs,
)
from ra_slam_tpu_torch.parallel.sharded_map import concat_shards
from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy

def port_cfg(jcfg) -> TsdfConfig:
    return TsdfConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def port_cam(cam) -> PinholeCamera:
    return PinholeCamera.create(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), cam.width, cam.height)


def slab_poses(k: int) -> np.ndarray:
    """tests/test_sharded_map.py's halo-test poses: the camera steps
    0.15 m in x and -0.1 m in z per frame."""
    return np.array([[1, 0, 0, 0.15 * k], [0, 1, 0, 0], [0, 0, 1, -0.1 * k], [0, 0, 0, 1]], np.float32)


def frames(poses, H=120, W=160):
    """(jax frame args, port frame args) per pose, on _frame()'s images."""
    cam, rgb, depth, ht, lt = _frame(H, W)
    t = lambda a: torch.tensor(np.asarray(a))
    tcam = port_cam(cam)
    out = []
    for p in poses:
        out.append(((rgb, depth, ht, lt, cam, JaxSE3.from_matrix(jnp.asarray(p))),
                    (t(rgb), t(depth), t(ht), t(lt), tcam, SE3.from_matrix(t(p)))))
    return out


def jax_sharded_op_by_op(jcfg, n, jax_frames, **kw):
    """JAX's shard body op by op over the frames: the stacked shard
    state (numpy leaves [n, ...]) and the stats of each frame."""
    lcfg = jsm.local_config(jcfg, n)
    stats = []
    with jax.disable_jit():
        m1 = jvm.create_map(lcfg)
        m1 = m1._replace(alloc_failures=m1.alloc_failures[None], free_top=m1.free_top[None])
        ms = jax.tree.map(lambda x: jnp.stack([x] * n), m1)
        body = functools.partial(jsm._sharded_integrate_frame, lcfg=lcfg, n_shards=n, **kw)
        for args in jax_frames:
            ms, st = jax.vmap(lambda m: body(m, *args), axis_name="map")(ms)
            stats.append({k: int(v[0]) for k, v in st.items()})
    return jax.tree.map(np.asarray, ms), stats


def port_sharded(cfg, n, port_frames, **kw):
    mesh = LocalMesh(n, "cpu")
    shards = create_sharded_map(cfg, mesh)
    step = make_sharded_integrate_step(mesh, cfg, **kw)
    stats = []
    for args in port_frames:
        shards, st = step(shards, *args)
        stats.append({k: int(v) for k, v in st.items()})
    return mesh, shards, stats


def jax_shard(stacked, i):
    """Shard i of a stacked JAX sharded map, its counters as scalars."""
    sh = jax.tree.map(lambda x: x[i], stacked)
    return sh._replace(alloc_failures=sh.alloc_failures[0], free_top=sh.free_top[0])


def stacked_from_global(gm, n):
    """A JAX sharded map's global arrays -> leaves [n, ...]."""
    return jax.tree.map(lambda x: np.asarray(x).reshape(n, -1, *np.shape(x)[1:]), gm)


def global_from_stacked(stacked):
    return jax.tree.map(lambda x: jnp.asarray(x.reshape(-1, *x.shape[2:])), stacked)


def assert_shards_match(stacked, shards, tol=tp.TOL):
    """Every shard: the JAX state vs the port's, integer state exactly,
    payload within `tol`."""
    for i, s in enumerate(shards):
        tp.assert_maps_match(jax_shard(stacked, i), voxel_map_to_numpy(s), tol)


def canon(rows):
    return rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]


@functools.lru_cache()
def _hash_run():
    """Both packages fuse _frame() twice at the identity pose over 2 hash
    shards; the port also on one map."""
    jcfg = _cfg()
    cfg = port_cfg(jcfg)
    fr = frames([np.eye(4, dtype=np.float32)] * 2)
    j, jstats = jax_sharded_op_by_op(jcfg, 2, [a for a, _ in fr], alloc_stride=1, carve=True)
    mesh, shards, stats = port_sharded(cfg, 2, [b for _, b in fr])
    single = tvm.create_map(cfg, "cpu")
    for _, b in fr:
        single, st1 = tvm.integrate_frame(single, *b, cfg)
    return jcfg, cfg, fr, j, jstats, mesh, shards, stats, single, int(st1["num_active"])


def test_owner_functions_match_jax():
    """owner_of and owner_slab on random int32 keys (negative block
    coordinates included) and on packed keys on both sides of the
    origin, exactly."""
    rng = np.random.default_rng(0)
    raw = rng.integers(-2**31, 2**31, 20000, dtype=np.int64).astype(np.int32)
    coords = rng.integers(-40, 40, (20000, 3)).astype(np.int32)
    packed = np.asarray(jblocks.pack_block_coords(jnp.asarray(coords)))
    assert (coords[:, 0] < 0).any() and (coords[:, 0] > 0).any()
    for keys in (raw, packed, np.array([0, 1, -1, jblocks.INVALID_KEY], np.int32)):
        for n in (1, 2, 3, 4, 8):
            np.testing.assert_array_equal(
                tblocks.owner_of(torch.tensor(keys), n).numpy(), np.asarray(jblocks.owner_of(jnp.asarray(keys), n)))
            for c in (0, 1, 2):
                np.testing.assert_array_equal(
                    tblocks.owner_slab(torch.tensor(keys), n, c).numpy(),
                    np.asarray(jblocks.owner_slab(jnp.asarray(keys), n, c)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 64])
def test_local_config_matches_jax(n):
    for jcfg in (_cfg(), dataclasses.replace(_cfg(), log2_num_blocks=17, log2_hash_size=19)):
        jl, tl = jsm.local_config(jcfg, n), local_config(port_cfg(jcfg), n)
        assert dataclasses.asdict(tl) == dataclasses.asdict(port_cfg(jl))


def test_sharded_fusion_matches_jax_shard_by_shard():
    """2 hash shards, 2 frames: every shard's keys, table, free stack and
    counters equal JAX's op-by-op shard body exactly, the payload within
    TOL; the stats equal frame by frame."""
    _, cfg, _, j, jstats, _, shards, stats, _, _ = _hash_run()
    assert stats == jstats
    assert stats[-1]["num_active"] > 200 and stats[-1]["alloc_failures"] == 0
    assert_shards_match(j, shards)
    assert [s.tsdf.shape[0] for s in shards] == [local_config(cfg, 2).num_blocks] * 2


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_state_matches_jitted_jax(n):
    """Against JAX's jitted shard_map step over n shards (hash
    ownership): the same keys, table slots, free stacks and counters on
    every shard; the payload differs where XLA's contracted projection
    picks another pixel (count printed)."""
    jcfg = _cfg()
    fr = frames([np.eye(4, dtype=np.float32)] * 2)
    mesh = Mesh(np.array(jax.devices()[:n]), ("map",))
    jm, jstep = jsm.create_sharded_map(jcfg, mesh), jsm.make_sharded_integrate_step(mesh, jcfg)
    for a, _ in fr:
        jm, jst = jstep(jm, *a)
    _, shards, stats = port_sharded(port_cfg(jcfg), n, [b for _, b in fr])
    assert stats[-1] == {k: int(v) for k, v in jst.items()}
    stacked = stacked_from_global(jax.device_get(jm), n)
    for i, s in enumerate(shards):
        tp.assert_maps_match(jax_shard(stacked, i), voxel_map_to_numpy(s), tol={})
    joined = concat_shards(shards)
    act = joined["active"]
    differ = {f: int((np.asarray(getattr(jax.device_get(jm), f))[act] != joined[f][act]).sum())
              for f in ("tsdf", "weight", "prob")}
    print(f"jitted JAX vs port, {n} shards: voxels whose payload differs {differ} of {int(act.sum()) * 512}")


def test_sharded_union_equals_single_map():
    """The union of the port's shards holds the port's single-map fusion
    of the same frames (tests/test_sharded_map.py's contract: num_active
    equal, the (x, y, z, tsdf, prob) rows within 1e-5)."""
    _, cfg, _, _, _, mesh, shards, stats, single, n1 = _hash_run()
    lcfg = local_config(cfg, mesh.size)
    assert stats[-1]["num_active"] == n1
    a = canon(np.concatenate([tvm.gather_valid_semantic(s, lcfg) for s in shards]))
    b = canon(tvm.gather_valid_semantic(single, cfg))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-5)
    specs = map_partition_specs()
    assert specs.block_key == specs.table.key == "map"
    assert concat_shards(shards)["block_key"].shape == (2 * lcfg.num_blocks,)


def test_gather_export_matches_jax():
    """`make_gather_shards` on the port's shards against JAX's jitted
    gather of JAX's op-by-op shards: the same config, dropped count,
    keys, table and active rows exactly, the payload within TOL (the
    gather moves data and adds none); the gathered map's semantic dump
    equals the single map's."""
    jcfg, cfg, _, j, _, mesh, shards, _, single, _ = _hash_run()
    jmesh = Mesh(np.array(jax.devices()[:2]), ("map",))
    jgather, jgcfg = jsm.make_gather_shards(jmesh, jcfg)
    jg, jdropped = jgather(global_from_stacked(j))
    gather, gcfg = make_gather_shards(mesh, cfg)
    g, dropped = gather(shards)
    assert dataclasses.asdict(gcfg) == dataclasses.asdict(port_cfg(jgcfg))
    assert int(dropped) == int(jdropped) == 0
    tp.assert_maps_match(jax.tree.map(np.asarray, jg), voxel_map_to_numpy(g))
    np.testing.assert_allclose(canon(tvm.gather_valid_semantic(g, gcfg)),
                               canon(tvm.gather_valid_semantic(single, cfg)), atol=1e-5)
    _, small_dropped = make_gather_shards(mesh, cfg, max_blocks_per_shard=64)[0](shards)
    _, jsmall = jsm.make_gather_shards(jmesh, jcfg, max_blocks_per_shard=64)[0](global_from_stacked(j))
    assert int(small_dropped) == int(jsmall) > 0
