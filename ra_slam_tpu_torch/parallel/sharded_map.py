"""Multi-shard TSDF map (counterpart of `ra_slam_tpu/parallel/sharded_map.py`).

  - The voxel-block pool and its spatial hash are partitioned by block
    key: by the owner hash (`blocks.owner_of`) or by x-slabs
    (`blocks.owner_slab`). Every shard holds an independent local pool
    and table (`local_config`: the global capacities split n ways) for
    the keys it owns. A sharded map is the list of the shards this
    process holds: all n under `LocalMesh`, its own under
    `ProcessGroupMesh`.
  - Images and the camera pose are replicated. Fusion needs no
    communication: allocation keeps the candidate keys the shard owns,
    and integration touches only local blocks, so every shard runs the
    single-map pipeline (`depth_to_candidate_keys` -> `allocate_keys` ->
    `visible_blocks` -> `integrate`, the fuse kernel on a GPU) at its
    local sizes. Only the per-frame stats are `psum`-reduced.
  - Export: `make_gather_shards` compacts each shard's active blocks,
    `all_gather`s them in shard order and inserts them into one fresh
    global map. With slab ownership, `extract_mesh_sharded` instead
    sends each shard's left-edge blocks to its left neighbour with one
    `ppermute` (`make_halo_augment`) and meshes every shard's own slab:
    per-shard memory O(local + halo).

Bodies run on a `parallel.mesh` mesh; what a body returns for every
shard alike (the gathered blocks) is computed once per process.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

import numpy as np
import torch

from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.map.blocks import (  # noqa: F401  (re-exports BLOCK_LEN, as JAX does)
    BLOCK_LEN, INVALID_KEY, owner_of, owner_slab, unpack_block_coords,
)
from ra_slam_tpu_torch.map.hash_table import HashTable, ht_insert
from ra_slam_tpu_torch.map.meshing import _mesh_arrays, emit_budgeted, extract_mesh
from ra_slam_tpu_torch.map.voxel_map import (
    VoxelMap,
    _count,
    _rank,
    allocate_keys,
    create_map,
    depth_to_candidate_keys,
    integrate,
    num_active,
    visible_blocks,
)

MAP_AXIS = "map"
_I32 = torch.int32


def local_config(cfg: TsdfConfig, n_shards: int) -> TsdfConfig:
    """Per-shard capacities: the global config split n ways (rounded up
    to powers of two: local table masks need power-of-two sizes)."""
    lb = max(math.ceil(math.log2(cfg.num_blocks / n_shards)), 6)
    lh = max(math.ceil(math.log2(cfg.hash_size / n_shards)), lb + 1)
    return dataclasses.replace(
        cfg,
        log2_num_blocks=lb,
        log2_hash_size=lh,
        max_visible_blocks=max(cfg.max_visible_blocks // n_shards, 64),
        max_new_blocks=max(cfg.max_new_blocks // n_shards, 64),
    )


def map_partition_specs() -> VoxelMap:
    """How a sharded map is laid out: every field of a `VoxelMap` split
    on its leading (block / table-slot) axis by MAP_AXIS, the scalars one
    per shard. The port keeps the shards as a list (`concat_shards`
    joins them into the global layout); there is no sharding pytree to
    hand to a compiler."""
    return VoxelMap(
        table=HashTable(MAP_AXIS, MAP_AXIS), block_key=MAP_AXIS, block_slot=MAP_AXIS,
        active=MAP_AXIS, tsdf=MAP_AXIS, weight=MAP_AXIS, rgb=MAP_AXIS, prob=MAP_AXIS,
        alloc_failures=MAP_AXIS, free_stack=MAP_AXIS, free_top=MAP_AXIS,
    )


def concat_shards(shards: List[VoxelMap]) -> dict:
    """The shards joined along their split axis (`map_partition_specs`)
    as numpy arrays keyed by field (`table.key`, `table.value`, ...):
    the global layout of the JAX package's sharded map, per-shard
    scalars becoming [n] vectors."""
    def joined(get):
        return np.concatenate([np.atleast_1d(get(s).cpu().numpy()) for s in shards])

    out = {"table.key": joined(lambda s: s.table.key), "table.value": joined(lambda s: s.table.value)}
    for f in dataclasses.fields(VoxelMap):
        if f.name != "table":
            out[f.name] = joined(lambda s: getattr(s, f.name))
    return out


def create_sharded_map(cfg: TsdfConfig, mesh) -> List[VoxelMap]:
    """This process's shards of an empty map with `cfg`'s global
    capacities: shard i holds the keys whose owner is i in a pool of
    `local_config(cfg, n)`; `alloc_failures` and `free_top` per shard."""
    lcfg = local_config(cfg, mesh.size)
    return [create_map(lcfg, mesh.device) for _ in mesh.local_shards]


def _owner_fn(owner_mode: str, cell_log2: int):
    if owner_mode == "hash":
        return owner_of
    if owner_mode == "slab":
        return functools.partial(owner_slab, cell_log2=cell_log2)
    raise ValueError(f"unknown owner_mode {owner_mode!r}")


def _sharded_integrate_frame(ctx, m: VoxelMap, rgb_img, depth_img, ht_img, lt_img, cam, cam_T_world,
                             lcfg: TsdfConfig, alloc_stride: int, carve: bool, owner) -> Tuple[VoxelMap, dict]:
    """Shard body: the single-map frame on the keys this shard owns."""
    keys = depth_to_candidate_keys(depth_img, cam, cam_T_world, lcfg, alloc_stride)
    keys = torch.where(owner(keys, ctx.size) == ctx.index, keys, INVALID_KEY)
    m = allocate_keys(m, keys)
    vis_idx, vis_mask, vis_count = visible_blocks(m, cam, cam_T_world, lcfg)
    m = integrate(m, vis_idx, vis_mask, rgb_img, depth_img, ht_img, lt_img, cam, cam_T_world, lcfg, carve=carve)
    stats = {
        "num_active": ctx.psum(num_active(m)),
        "num_visible": ctx.psum(vis_count),
        "alloc_failures": ctx.psum(m.alloc_failures),
    }
    return m, stats


def make_sharded_integrate_step(mesh, cfg: TsdfConfig, alloc_stride: int = 1, carve: bool = True,
                                owner_mode: str = "hash", cell_log2: int = 2):
    """The sharded per-frame fusion step on `mesh`:
    step(shards, rgb, depth, ht, lt, cam, cam_T_world) -> (shards,
    stats), the shards from `create_sharded_map` updated in place, the
    stats (num_active, num_visible, alloc_failures) summed over every
    shard. `owner_mode="slab"` assigns x-slab ownership, which the
    halo-exchange export (`extract_mesh_sharded`) needs."""
    lcfg = local_config(cfg, mesh.size)
    owner = _owner_fn(owner_mode, cell_log2)

    def step(shards, rgb_img, depth_img, ht_img, lt_img, cam, cam_T_world):
        body = functools.partial(
            _sharded_integrate_frame, rgb_img=rgb_img, depth_img=depth_img, ht_img=ht_img, lt_img=lt_img,
            cam=cam, cam_T_world=cam_T_world, lcfg=lcfg, alloc_stride=alloc_stride, carve=carve, owner=owner,
        )
        out = mesh.run(body, shards)
        return [m for m, _ in out], out[0][1]

    return step


# ---------------------------------------------------------------------------
# Export: the gather collective for meshing, raycast, dumps
# ---------------------------------------------------------------------------


def _compact(x: torch.Tensor, keep: torch.Tensor, dest: torch.Tensor, cap: int, fill) -> torch.Tensor:
    """Rows `keep` of x written to rows `dest` of a [cap, ...] buffer of `fill`."""
    out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    out[dest] = x[keep]
    return out


def _gather_shards_body(ctx, m: VoxelMap, cap: int):
    """Shard body: compact the shard's active blocks (cumsum rank, the
    allocation's trick) into `cap` rows and `all_gather` them in shard
    order. Returns ((keys, tsdf, weight, rgb, prob) of every shard, the
    blocks over the caps summed over shards)."""
    act = m.active
    rank = _rank(act)
    keep = act & (rank < cap)
    dest = rank[keep].long()
    fields = [(m.block_key, INVALID_KEY), (m.tsdf, -1.0), (m.weight, 0.0), (m.rgb, 0.0), (m.prob, 0.5)]
    rows = [_compact(x, keep, dest, cap, fill) for x, fill in fields]
    dropped = num_active(m) - _count(rows[0] != INVALID_KEY)
    return [ctx.all_gather(x) for x in rows], ctx.psum(dropped)


def _insert_global(gathered, gcfg: TsdfConfig, device) -> Tuple[VoxelMap, torch.Tensor]:
    """One fresh map of `gcfg` holding the gathered blocks, inserted in
    gather order (its free stack is not maintained: for export). Returns
    (map, blocks whose bucket was full)."""
    keys_g, tsdf_g, weight_g, rgb_g, prob_g = gathered
    g = create_map(gcfg, device)
    pool_idx = torch.arange(keys_g.shape[0], dtype=_I32, device=device)
    valid = keys_g != INVALID_KEY
    slots, placed = ht_insert(g.table, keys_g, pool_idx, valid)
    rows = pool_idx[placed].long()
    g.block_key[rows] = keys_g[placed]
    g.block_slot[rows] = slots[placed]
    g.active[rows] = True
    g.tsdf[rows] = tsdf_g[placed]
    g.weight[rows] = weight_g[placed]
    g.rgb[rows] = rgb_g[placed]
    g.prob[rows] = prob_g[placed]
    return g, _count(valid & ~placed)


def make_gather_shards(mesh, cfg: TsdfConfig, max_blocks_per_shard: int | None = None):
    """gather(shards) -> (global map, dropped), and the global map's
    config. The map is an ordinary `VoxelMap` with `cfg`'s capacities
    (rounded up when n * cap exceeds them), holding the union of the
    shards: `extract_mesh`, `raycast` and the dumps run on it unchanged.
    `dropped` counts blocks lost to the per-shard cap or a full bucket
    (0 within bounds). Every process gets the whole map."""
    n = mesh.size
    lcfg = local_config(cfg, n)
    cap = max_blocks_per_shard or lcfg.num_blocks
    gcfg = cfg
    if n * cap > cfg.num_blocks:  # round the shards' overprovision back up
        lb = math.ceil(math.log2(n * cap))
        gcfg = dataclasses.replace(cfg, log2_num_blocks=lb, log2_hash_size=max(cfg.log2_hash_size, lb + 2))

    def gather(shards):
        gathered, dropped = mesh.run(functools.partial(_gather_shards_body, cap=cap), shards)[0]
        g, lost = _insert_global(gathered, gcfg, mesh.device)
        return g, dropped + lost

    return gather, gcfg


# ---------------------------------------------------------------------------
# Neighbour halo exchange (slab ownership): O(local + halo) export
# ---------------------------------------------------------------------------


def _clone_map(m: VoxelMap) -> VoxelMap:
    return VoxelMap(**{
        f.name: (HashTable(m.table.key.clone(), m.table.value.clone()) if f.name == "table"
                 else getattr(m, f.name).clone())
        for f in dataclasses.fields(VoxelMap)
    })


def _halo_augment_body(ctx, m: VoxelMap, cap_h: int, cell_log2: int) -> Tuple[VoxelMap, torch.Tensor]:
    """Shard body: send this shard's left-edge active blocks (bx = 0 mod
    2^c, the only blocks another shard's 2x2x2 corner neighbourhood can
    reach) to the shard on the left with one `ppermute`, and insert the
    received halo into a copy of the local pool and table as inactive
    rows: the mesher's neighbour lookups find them, the shard's own
    emission never iterates them. Halo rows take the lowest-numbered
    inactive rows in order and leave the free stack as it was, so the
    copy is for export only. Returns (copy, blocks dropped, summed)."""
    n = ctx.size
    bx = unpack_block_coords(m.block_key)[:, 0]
    edge = m.active & (torch.remainder(bx, 1 << cell_log2) == 0)
    rank = _rank(edge)
    keep = edge & (rank < cap_h)
    dest = rank[keep].long()
    fields = [(m.block_key, INVALID_KEY), (m.tsdf, 1.0), (m.weight, 0.0), (m.prob, 0.5), (m.rgb, 0.0)]
    send = [_compact(x, keep, dest, cap_h, fill) for x, fill in fields]
    dropped = _count(edge) - _count(send[0] != INVALID_KEY)

    # deliver shard i+1's buffer to shard i (the +x neighbour's slab)
    perm = [(i, (i - 1) % n) for i in range(n)]
    rk, rt, rw, rp, rc = (ctx.ppermute(x, perm) for x in send)

    a = _clone_map(m)
    N = a.num_blocks
    free = ~m.active
    frank = _rank(free)
    fkeep = free & (frank < cap_h)
    freelist = torch.full((cap_h,), -1, dtype=_I32, device=a.device)
    freelist[frank[fkeep].long()] = torch.arange(N, dtype=_I32, device=a.device)[fkeep]
    hvalid = rk != INVALID_KEY
    row = torch.where(hvalid, freelist, -1)
    placed_pool = hvalid & (row >= 0)
    slots, placed_ht = ht_insert(a.table, rk, torch.clamp(row, min=0), placed_pool)
    ok = placed_pool & placed_ht
    dropped = dropped + _count(hvalid & ~ok)
    w = row[ok].long()
    a.block_key[w] = rk[ok]
    a.block_slot[w] = slots[ok]
    a.tsdf[w] = rt[ok]
    a.weight[w] = rw[ok]
    a.prob[w] = rp[ok]
    a.rgb[w] = rc[ok]
    return a, ctx.psum(dropped)


def make_halo_augment(mesh, cfg: TsdfConfig, cell_log2: int = 2, max_halo_per_shard: int | None = None):
    """augment(shards) -> (augmented copies, dropped), and the local
    config. The map must have been fused with `owner_mode="slab"` and
    the same `cell_log2`; each copy additionally holds its +x halo as
    inactive rows (the shards themselves are not changed)."""
    lcfg = local_config(cfg, mesh.size)
    cap_h = max_halo_per_shard or max(256, lcfg.num_blocks >> max(cell_log2 - 1, 0))

    def augment(shards):
        out = mesh.run(functools.partial(_halo_augment_body, cap_h=cap_h, cell_log2=cell_log2), shards)
        return [a for a, _ in out], out[0][1]

    return augment, lcfg


def _surface_blocks(m: VoxelMap) -> int:
    """Pool rows holding a keyed block with weight (halo rows included):
    the per-shard memory the halo export needs."""
    return int(_count((m.block_key != INVALID_KEY) & (m.weight.amax(dim=-1) > 0)))


def make_mesh_shards(mesh, cfg: TsdfConfig, cell_log2: int = 2, min_weight: float = 1.5, chunk: int = 256,
                     cap_shard: int | None = None, c_max: int | None = None):
    """The all-shards-at-once mesh extraction: every shard emits its own
    active blocks' triangles under static budgets (`emit_budgeted`:
    `c_max` per chunk of `chunk` blocks, `cap_shard` in all), merges
    their vertices and quantizes them over its own bounding box.

    Returns (fn: augmented shards -> per local shard (vertices, indices,
    probs, triangles kept, triangles cut, surface blocks), lcfg,
    cap_shard)."""
    lcfg = local_config(cfg, mesh.size)
    if cap_shard is None:
        # ~96 emitted triangles per allocated block: 3x the average of a
        # room-scale map (7.3M triangles / 0.26 surface share / 131k blocks)
        cap_shard = max(1 << 14, (cfg.num_blocks * 96) // mesh.size)
    if c_max is None:
        c_max = min(chunk * 1024, cap_shard)

    def body(ctx, m: VoxelMap):
        parts, n_tris, cut = emit_budgeted(m, min_weight, chunk, c_max, cap_shard)
        return (*_mesh_arrays(parts, lcfg.voxel_size), n_tris, cut, _surface_blocks(m))

    return (lambda shards: mesh.run(body, shards)), lcfg, cap_shard


def _concat_meshes(meshes):
    """(vertices, indices, probs) of per-shard meshes, concatenated with
    the index offsets."""
    verts, idx, probs, off = [], [], [], 0
    for v, t, p in meshes:
        if len(v):
            verts.append(v)
            idx.append(t + off)
            probs.append(p)
            off += len(v)
    if not verts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), np.zeros((0,), np.float32)
    return np.concatenate(verts), np.concatenate(idx), np.concatenate(probs)


def extract_mesh_sharded(shards, mesh, cfg: TsdfConfig, cell_log2: int = 2, min_weight: float = 1.5,
                         mode: str = "parallel", **mesh_kw):
    """Mesh a slab-sharded map with O(local + halo) memory per shard.

    One halo `ppermute`, then each shard triangulates only its own
    active blocks: slabs are disjoint, so the per-shard meshes (each
    quantized over its own bounding box) concatenated in shard order are
    the global mesh. mode="parallel": every shard meshes under static
    budgets (`make_mesh_shards`; `chunk`, `cap_shard`, `c_max`) and an
    overflow raises ValueError. mode="sequential": `extract_mesh` on
    each shard (`chunk`, `max_tris`). Under `ProcessGroupMesh` the
    per-shard meshes reach every process. Returns (vertices [V, 3],
    indices [T, 3], probs [V], stats dict)."""
    if mode == "parallel":
        return _extract_mesh_sharded_parallel(shards, mesh, cfg, cell_log2=cell_log2, min_weight=min_weight,
                                              **mesh_kw)
    augment, lcfg = make_halo_augment(mesh, cfg, cell_log2=cell_log2)
    m_aug, dropped = augment(shards)
    local = [(extract_mesh(a, lcfg, min_weight=min_weight, **mesh_kw), _surface_blocks(a)) for a in m_aug]
    every = mesh.all_shards(local)
    v, t, p = _concat_meshes([mesh_i for mesh_i, _ in every])
    peak = max(b for _, b in every) if len(v) else 0
    return v, t, p, {"dropped": int(dropped), "peak_blocks_per_shard": peak}


def _extract_mesh_sharded_parallel(shards, mesh, cfg: TsdfConfig, cell_log2: int = 2, min_weight: float = 1.5,
                                   chunk: int = 256, cap_shard: int | None = None, c_max: int | None = None,
                                   **_ignored):
    augment, _ = make_halo_augment(mesh, cfg, cell_log2=cell_log2)
    m_aug, dropped = augment(shards)
    fn, _, _ = make_mesh_shards(mesh, cfg, cell_log2=cell_log2, min_weight=min_weight, chunk=chunk,
                                cap_shard=cap_shard, c_max=c_max)
    every = mesh.all_shards(fn(m_aug))
    cut = [s[4] for s in every]
    if sum(cut):
        raise ValueError(f"sharded mesh overflow (per-shard drops {cut}); raise cap_shard / c_max")
    n_tris = [s[3] for s in every]
    v, t, p = _concat_meshes([s[:3] for s in every])
    stats = {
        "dropped": int(dropped),
        "peak_blocks_per_shard": max(s[5] for s in every),
        "peak_tris_per_shard": max(n_tris),
        "per_shard_tris": n_tris,
    }
    return v, t, p, stats
