"""The sparse semantic TSDF voxel map: allocation, fusion, carving, export
(counterpart of `ra_slam_tpu/map/voxel_map.py`).

Same behavior as the JAX package, step for step:

  allocate   sort-unique of per-pixel candidate keys, hash lookup,
             free-row stack pop, rank-protocol hash insert
  cull       frustum test of every active block's 8 corners, compaction
             to a fixed `max_visible_blocks` window
  prep       per-voxel projection: the pixel each voxel samples, its
             camera depth, depth-to-range scale and update gate
  fuse       `ops/tsdf_fuse.py`: the CUDA kernel on the GPU, its plain
             PyTorch version on the CPU
  carve      release visible blocks whose min |tsdf| >= threshold

The map is updated IN PLACE: every function that changes it writes into
its tensors and returns the same `VoxelMap` (the JAX step donates its
input map, so no caller keeps the old state). Every scatter whose JAX
form is `.at[i].set(..., mode="drop")` with a sentinel index is a
boolean mask applied before `index_put_`, so the indices written are
unique and the result is deterministic on every device.

Integer and float operations keep the JAX package's order, so that on
the CPU the keys, table, pool rows and free stack equal the JAX
package's exactly (tests/test_torch_voxel_map.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.map.blocks import (
    BLOCK_LEN,
    BLOCK_VOLUME,
    INVALID_KEY,
    pack_block_coords,
    unpack_block_coords,
    voxel_offsets,
)
from ra_slam_tpu_torch.map.hash_table import HashTable, ht_insert, ht_lookup, ht_remove
from ra_slam_tpu_torch.ops.tsdf_fuse import tsdf_fuse_
from ra_slam_tpu_torch.utils.profiling import TRACE

_I32 = torch.int32


@dataclass
class VoxelMap:
    """Fixed-capacity SoA voxel-block pool + spatial hash."""

    table: HashTable
    block_key: torch.Tensor  # [N] int32, INVALID_KEY when free
    block_slot: torch.Tensor  # [N] int32 table slot, -1 when free
    active: torch.Tensor  # [N] bool
    tsdf: torch.Tensor  # [N, 512] float32 in [-1, 1]
    weight: torch.Tensor  # [N, 512] float32
    rgb: torch.Tensor  # [N, 3, 512] float32 in [0, 255], channel-major
    prob: torch.Tensor  # [N, 512] float32 high-touch probability
    alloc_failures: torch.Tensor  # int32 scalar, cumulative
    # rows free_stack[0:free_top] are the free pool rows; allocation pops
    # from the top, carving pushes released rows back
    free_stack: torch.Tensor  # [N] int32 pool-row ids
    free_top: torch.Tensor  # int32 scalar

    @property
    def num_blocks(self) -> int:
        return self.block_key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.block_key.device


def create_map(cfg: TsdfConfig, device) -> VoxelMap:
    """An empty map. Free rows hold the acquire-time init values (tsdf=-1,
    weight=1, prob=0.5), so allocation never writes payloads."""
    n = cfg.num_blocks
    kw = dict(device=device)
    return VoxelMap(
        table=HashTable.create(cfg.log2_hash_size, device),
        block_key=torch.full((n,), INVALID_KEY, dtype=_I32, **kw),
        block_slot=torch.full((n,), -1, dtype=_I32, **kw),
        active=torch.zeros((n,), dtype=torch.bool, **kw),
        tsdf=torch.full((n, BLOCK_VOLUME), -1.0, dtype=torch.float32, **kw),
        weight=torch.ones((n, BLOCK_VOLUME), dtype=torch.float32, **kw),
        rgb=torch.zeros((n, 3, BLOCK_VOLUME), dtype=torch.float32, **kw),
        prob=torch.full((n, BLOCK_VOLUME), 0.5, dtype=torch.float32, **kw),
        alloc_failures=torch.zeros((), dtype=_I32, **kw),
        free_stack=torch.arange(n, dtype=_I32, **kw),
        free_top=torch.tensor(n, dtype=_I32, **kw),
    )


def num_active(m: VoxelMap) -> torch.Tensor:
    return m.active.sum(dtype=_I32)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=_I32)


def _rank(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive position of each set entry among the set entries."""
    return torch.cumsum(mask.to(_I32), dim=0, dtype=_I32) - 1


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's: torch's vectorized CPU
    sqrt is off by one ulp for some inputs. A float64 sqrt rounded to
    float32 is exact."""
    return torch.sqrt(x.double()).float()


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c rounded as IEEE division on every device: CUDA divides by a
    Python scalar through its reciprocal, which can differ in the last
    bit from the CPU (and from JAX)."""
    return a / torch.tensor(c, dtype=a.dtype, device=a.device)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32, saturating out-of-range values like XLA's
    conversion (a bare cast gives INT_MIN for +huge on x86)."""
    return x.clamp(-(2.0**30), 2.0**30).to(_I32)


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


def allocate_keys(
    m: VoxelMap, cand_keys: torch.Tensor, max_new_blocks: int = 8192
) -> VoxelMap:
    """Allocate blocks for a batch of candidate keys [M] (may contain
    duplicates and INVALID_KEY), in place."""
    n = m.num_blocks
    dev = cand_keys.device
    M = cand_keys.shape[0]

    # 1. sort + dedup (INVALID_KEY sorts to the end and is dropped)
    skeys = torch.sort(cand_keys).values
    uniq = (skeys != torch.roll(skeys, 1)) & (skeys != INVALID_KEY)
    uniq[0] = skeys[0] != INVALID_KEY
    n_uniq = _count(uniq)

    # 2. compact the unique keys to a window of u_cap
    take = min(max_new_blocks, M)
    u_cap = min(2 * take, M)
    dest = _rank(uniq)
    keep = uniq & (dest < u_cap)
    ukeys = torch.full((u_cap,), INVALID_KEY, dtype=_I32, device=dev)
    ukeys[dest[keep].long()] = skeys[keep]
    uniq_dropped = torch.clamp(n_uniq - u_cap, min=0)

    # 3. drop keys already in the table, compact the first take new keys
    exists = ht_lookup(m.table, ukeys) >= 0
    new_mask = (ukeys != INVALID_KEY) & ~exists
    n_new = _count(new_mask)
    dest = _rank(new_mask)
    keep = new_mask & (dest < take)
    cand = torch.full((take,), INVALID_KEY, dtype=_I32, device=dev)
    cand[dest[keep].long()] = ukeys[keep]
    cvalid = cand != INVALID_KEY
    overflow = n_new - _count(cvalid) + uniq_dropped

    # 4. pop free pool rows off the stack: cvalid is a prefix mask, so
    #    candidate i takes stack position free_top-1-i
    stack_pos = m.free_top - 1 - torch.arange(take, dtype=_I32, device=dev)
    havepool = (stack_pos >= 0) & cvalid
    pool_idx = torch.where(
        havepool, m.free_stack[torch.clamp(stack_pos, 0, n - 1).long()], -1
    )
    ins_valid = cvalid & havepool
    pool_exhausted = _count(cvalid & ~havepool)

    # 5. rank-protocol insert into the hash table
    slots, placed = ht_insert(m.table, cand, pool_idx, ins_valid)
    n_popped = _count(ins_valid)
    probe_failed = n_popped - _count(placed)

    # 5b. rows whose bucket was full go back onto the stack
    failed = ins_valid & ~placed
    new_top = m.free_top - n_popped + probe_failed
    fdest = m.free_top - n_popped + torch.cumsum(failed.to(_I32), 0, dtype=_I32) - 1
    m.free_stack[fdest[failed].long()] = pool_idx[failed]

    # 6. activate the acquired blocks (free rows are pre-initialized)
    bidx = pool_idx[placed].long()
    m.block_key[bidx] = cand[placed]
    m.block_slot[bidx] = slots[placed]
    m.active[bidx] = True

    m.free_top = new_top.to(_I32)
    m.alloc_failures = (
        m.alloc_failures + overflow + pool_exhausted + probe_failed
    ).to(_I32)
    return m


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """float32 linspace computed as `jnp.linspace` computes it (its last
    bits differ from `torch.linspace`)."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def depth_to_candidate_keys(
    depth: torch.Tensor,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    stride: int = 1,
) -> torch.Tensor:
    """Per-pixel candidate block keys: back-project depth and sample the
    ray segment [d - truncation, d + truncation]. Returns flat [M] keys
    with INVALID_KEY for invalid pixels."""
    dev = depth.device
    block_size = BLOCK_LEN * cfg.voxel_size
    # sample spacing <= half a block so no crossed block is skipped
    n_steps = int(2 * cfg.truncation / (0.5 * block_size)) + 2

    d = depth[::stride, ::stride]
    h, w = d.shape
    u = (torch.arange(w, dtype=torch.float32, device=dev) * stride).expand(h, w)
    v = (torch.arange(h, dtype=torch.float32, device=dev) * stride)[:, None].expand(h, w)
    valid = (d > cfg.min_depth) & (d <= cfg.max_depth)

    uv = torch.stack([u, v], dim=-1)
    p_cam = cam.unproject(uv, torch.where(valid, d, torch.ones_like(d)))  # [h, w, 3]
    ray_len = _sqrt((p_cam * p_cam).sum(dim=-1, keepdim=True))
    u_dir = p_cam / torch.clamp(ray_len, min=1e-9)

    ts = _linspace(-cfg.truncation, cfg.truncation, n_steps, dev)
    pts_cam = p_cam[..., None, :] + u_dir[..., None, :] * ts[:, None]  # [h, w, S, 3]
    pts_world = cam_T_world.inverse().apply(pts_cam)

    bcoords = _to_i32(torch.floor(pts_world / block_size))
    keys = pack_block_coords(bcoords)
    keys = torch.where(valid[..., None], keys, INVALID_KEY)
    return keys.reshape(-1)


def allocate_from_depth(
    m: VoxelMap,
    depth: torch.Tensor,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    stride: int = 1,
) -> VoxelMap:
    keys = depth_to_candidate_keys(depth, cam, cam_T_world, cfg, stride)
    return allocate_keys(m, keys, cfg.max_new_blocks)


# ---------------------------------------------------------------------------
# Visibility + compaction
# ---------------------------------------------------------------------------


def visible_blocks(
    m: VoxelMap,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Conservative frustum culling over the whole pool + compaction.

    Returns (indices [Vmax] int32, mask [Vmax] bool, count) where count
    may exceed Vmax (overflow is clamped). Padding slots hold row 0.
    """
    dev = m.device
    block_size = BLOCK_LEN * cfg.voxel_size
    base = unpack_block_coords(m.block_key).to(torch.float32) * block_size
    corner_offs = torch.tensor(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=torch.float32, device=dev,
    ) * block_size  # [8, 3]
    corners = base[:, None, :] + corner_offs[None]  # [N, 8, 3]
    c_cam = cam_T_world.apply(corners)
    uv, z = cam.project(c_cam)
    u, v = uv[..., 0], uv[..., 1]

    zmax = cfg.max_depth + cfg.truncation
    out = (
        (z <= 0.0).all(dim=1)
        | (z > zmax).all(dim=1)
        | (u < 0.0).all(dim=1)
        | (u > cam.width - 1).all(dim=1)
        | (v < 0.0).all(dim=1)
        | (v > cam.height - 1).all(dim=1)
    )
    visible = m.active & ~out

    count = _count(visible)
    vmax = cfg.max_visible_blocks
    dest = _rank(visible)
    keep = visible & (dest < vmax)
    idx = torch.zeros((vmax,), dtype=_I32, device=dev)
    idx[dest[keep].long()] = torch.arange(m.num_blocks, dtype=_I32, device=dev)[keep]
    mask = torch.arange(vmax, device=dev) < torch.clamp(count, max=vmax)
    return idx, mask, count


# ---------------------------------------------------------------------------
# Integration
# ---------------------------------------------------------------------------


def integrate_prep(
    m: VoxelMap,
    vis_idx: torch.Tensor,
    vis_mask: torch.Tensor,
    height: int,
    width: int,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
):
    """Project the visible voxels: the pixel each one samples and its
    gating. Returns (pix [V,512] int32 flat index y*W+x, z_cam, d2r,
    gate [V,512] float32).

    The JAX package reads pixels through a mip-tile atlas (a flat gather
    is slow on the TPU). This reads the same pixel directly: for the
    block's mip level `lvl`, chosen so its footprint spans at most 8
    pixels at that level, voxel (uc, vc) samples full-resolution pixel
    ((vc>>lvl)<<lvl, (uc>>lvl)<<lvl). A voxel whose level-`lvl` pixel
    falls outside the block's 16x16 tile (`in_patch`) does not update,
    as in the JAX package. Per voxel, every result equals the JAX
    package's `_integrate_prep` + atlas read exactly.
    """
    H, W = height, width
    dev = m.device
    P = 8  # max footprint span at the chosen level
    TP = 16  # tile edge
    base_voxel = unpack_block_coords(m.block_key[vis_idx.long()]) * BLOCK_LEN  # [V, 3]
    grid = base_voxel[:, None, :] + voxel_offsets(dev)[None]  # [V, 512, 3]
    world = grid.to(torch.float32) * cfg.voxel_size
    p_cam = cam_T_world.apply(world)
    uv, z_cam = cam.project(p_cam)

    ui = _to_i32(torch.round(uv[..., 0]))
    vi = _to_i32(torch.round(uv[..., 1]))
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z_cam > 0)
    uc = torch.clamp(ui, 0, W - 1)
    vc = torch.clamp(vi, 0, H - 1)

    # enough levels that any in-bounds footprint fits: span>>lvl <= P-1
    n_levels = max(1, (max(H, W) + P - 1) // P - 1).bit_length() + 1
    level_w = torch.tensor(
        [-(-W // (1 << l)) for l in range(n_levels)], dtype=_I32, device=dev
    )
    level_h = torch.tensor(
        [-(-H // (1 << l)) for l in range(n_levels)], dtype=_I32, device=dev
    )

    # per-block footprint over in-bounds voxels
    big = 1 << 20
    umin = torch.where(inb, ui, big).amin(dim=1)
    vmin = torch.where(inb, vi, big).amin(dim=1)
    umax = torch.where(inb, ui, -big).amax(dim=1)
    vmax = torch.where(inb, vi, -big).amax(dim=1)
    any_valid = inb.any(dim=1)
    umin = torch.where(any_valid, torch.clamp(umin, min=0), 0)
    vmin = torch.where(any_valid, torch.clamp(vmin, min=0), 0)
    span = torch.maximum(umax - umin, vmax - vmin)  # [V]
    lvl = torch.zeros_like(span)
    for l in range(n_levels - 1):
        lvl = lvl + (span > (1 << l) * P - 1).to(_I32)

    lvl_l = lvl.long()
    u0 = torch.clamp(umin >> lvl, min=0)
    u0 = torch.minimum(u0, torch.clamp(level_w[lvl_l] - 1, min=0))
    v0 = torch.clamp(vmin >> lvl, min=0)
    v0 = torch.minimum(v0, torch.clamp(level_h[lvl_l] - 1, min=0))
    tx = u0 >> 3
    ty = v0 >> 3

    lv = lvl[:, None]
    ul = uc >> lv
    vl = vc >> lv
    du = ul - (tx << 3)[:, None]
    dv = vl - (ty << 3)[:, None]
    in_patch = (du >= 0) & (du < TP) & (dv >= 0) & (dv < TP)

    # depth-to-range scale at the pixel actually sampled
    us = ul << lv
    vs = vl << lv
    xn = (us.to(torch.float32) - cam.cx) / cam.fx
    yn = (vs.to(torch.float32) - cam.cy) / cam.fy
    d2r = _sqrt(xn * xn + yn * yn + 1.0)

    gate = (vis_mask[:, None] & inb & in_patch).to(torch.float32)
    pix = vs * W + us
    return pix, z_cam.contiguous(), d2r, gate


def image_planes(
    rgb_img: torch.Tensor,
    depth_img: torch.Tensor,
    ht_img: torch.Tensor,
    lt_img: torch.Tensor,
) -> torch.Tensor:
    """[6, H*W] float32 planes: depth | r | g | b | ht | lt."""
    H, W = depth_img.shape
    return torch.stack(
        [depth_img, rgb_img[..., 0], rgb_img[..., 1], rgb_img[..., 2], ht_img, lt_img]
    ).reshape(6, H * W)


def _release_rows(m: VoxelMap, vis_idx: torch.Tensor, release: torch.Tensor) -> None:
    """Free the visible blocks under `release`: hash delete, metadata
    clear, free-stack push, and the acquire-time init of their rows."""
    rows = vis_idx[release].long()
    ht_remove(m.table, m.block_slot[vis_idx.long()], release)
    m.block_key[rows] = INVALID_KEY
    m.block_slot[rows] = -1
    m.active[rows] = False
    sdest = m.free_top + _rank(release)
    m.free_stack[sdest[release].long()] = vis_idx[release]
    m.free_top = (m.free_top + _count(release)).to(_I32)
    m.tsdf[rows] = -1.0
    m.weight[rows] = 1.0
    m.rgb[rows] = 0.0
    m.prob[rows] = 0.5


def integrate(
    m: VoxelMap,
    vis_idx: torch.Tensor,
    vis_mask: torch.Tensor,
    rgb_img: torch.Tensor,  # [H, W, 3] float32 0..255
    depth_img: torch.Tensor,  # [H, W] float32 meters
    ht_img: torch.Tensor,  # [H, W] float32 prob
    lt_img: torch.Tensor,  # [H, W] float32 prob
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    carve: bool = False,
) -> VoxelMap:
    """Fuse one RGB-D(+semantics) frame into the visible blocks, in place.

    With `carve=True`, visible blocks whose min |tsdf| after the update
    is >= `carve_threshold` are released (the fuse kernel emits that
    per-block min).
    """
    H, W = depth_img.shape
    with TRACE.span("map.prep"):
        pix, z_cam, d2r, gate = integrate_prep(
            m, vis_idx, vis_mask, H, W, cam, cam_T_world, cfg
        )
        img6 = image_planes(rgb_img, depth_img, ht_img, lt_img)
    with TRACE.span("map.fuse"):
        minabs = tsdf_fuse_(m, vis_idx, vis_mask, img6, pix, z_cam, d2r, gate, cfg)
    if carve:
        with TRACE.span("map.carve"):
            _release_rows(m, vis_idx, vis_mask & (minabs >= cfg.carve_threshold))
    return m


# ---------------------------------------------------------------------------
# Space carving
# ---------------------------------------------------------------------------


def space_carve(
    m: VoxelMap,
    vis_idx: torch.Tensor,
    vis_mask: torch.Tensor,
    cfg: TsdfConfig,
) -> VoxelMap:
    """Release visible blocks whose min |tsdf| >= threshold (entirely
    empty space), at most 4096 per call, in place."""
    min_abs = m.tsdf[vis_idx.long()].abs().amin(dim=-1)
    release = vis_mask & (min_abs >= cfg.carve_threshold)
    r_cap = min(4096, vis_idx.shape[0])
    release = release & (_rank(release) < r_cap)
    _release_rows(m, vis_idx, release)
    return m


# ---------------------------------------------------------------------------
# Per-frame pipeline
# ---------------------------------------------------------------------------


def integrate_frame(
    m: VoxelMap,
    rgb_img: torch.Tensor,
    depth_img: torch.Tensor,
    ht_img: torch.Tensor,
    lt_img: torch.Tensor,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    alloc_stride: int = 1,
    carve: bool = True,
) -> Tuple[VoxelMap, dict]:
    """allocate -> cull -> integrate -> carve: one fused-map frame, in
    place. Returns the map and int32 scalar stats tensors."""
    with TRACE.span("map.integrate_frame"):
        with TRACE.span("map.allocate"):
            m = allocate_from_depth(m, depth_img, cam, cam_T_world, cfg, alloc_stride)
        with TRACE.span("map.cull"):
            vis_idx, vis_mask, vis_count = visible_blocks(m, cam, cam_T_world, cfg)
        m = integrate(
            m, vis_idx, vis_mask, rgb_img, depth_img, ht_img, lt_img,
            cam, cam_T_world, cfg, carve=carve,
        )
    stats = {
        "num_active": num_active(m),
        "num_visible": vis_count,
        "alloc_failures": m.alloc_failures,
    }
    return m, stats


# ---------------------------------------------------------------------------
# Export (reference binary layouts kept byte-compatible)
# ---------------------------------------------------------------------------


def _active_rows(m: VoxelMap, cfg: TsdfConfig, fields) -> np.ndarray:
    """(x, y, z, *fields) float32 rows of every voxel of every active
    block, computed on the map's device."""
    idx = torch.nonzero(m.active).squeeze(1)
    coords = unpack_block_coords(m.block_key[idx]) * BLOCK_LEN
    grid = coords[:, None, :] + voxel_offsets(m.device)[None]  # [K, 512, 3]
    pos = grid.to(torch.float32) * cfg.voxel_size
    cols = [pos] + [f[idx][..., None] for f in fields]
    return torch.cat(cols, dim=-1).reshape(-1, 3 + len(fields)).cpu().numpy()


def gather_valid(m: VoxelMap, cfg: TsdfConfig) -> np.ndarray:
    """All voxels of active blocks as (x, y, z, tsdf) float32 rows."""
    return _active_rows(m, cfg, [m.tsdf])


def gather_valid_semantic(m: VoxelMap, cfg: TsdfConfig) -> np.ndarray:
    """(x, y, z, tsdf, prob) float32 rows — the format of the reference's
    `GatherValidSemantic` and of the ScanNet eval harness."""
    return _active_rows(m, cfg, [m.tsdf, m.prob])


def query_tsdf(m: VoxelMap, cfg: TsdfConfig, lo, hi) -> np.ndarray:
    """Voxels inside the world-space AABB [lo, hi] as (x, y, z, tsdf) rows."""
    rows = gather_valid(m, cfg)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    keep = np.all((rows[:, :3] >= lo) & (rows[:, :3] <= hi), axis=-1)
    return rows[keep]


def dump_semantic_tsdf(m: VoxelMap, cfg: TsdfConfig, path: str) -> int:
    """Write all active voxels as packed (x, y, z, tsdf, prob) float32
    rows (the reference's `DownloadAll` layout). Returns the row count."""
    rows = gather_valid_semantic(m, cfg)
    rows.astype("<f4").tofile(path)
    return len(rows)
