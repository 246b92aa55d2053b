"""Raycast rendering of the TSDF map by splatting (counterpart of
`ra_slam_tpu/map/raycast.py`).

Every voxel of every frustum-visible block reports where the surface is,
instead of rays searching for it:

  1. cull and compact the active blocks (`visible_blocks`), then keep
     the first V2 = `max_shell_blocks or max_visible_blocks // 2` blocks
     that hold any renderable voxel (|tsdf| < shell, weight >=
     `raycast_min_weight`); the voxels of blocks beyond V2 are counted in
     `dropped_splats` (512 per block);
  2. project the voxel centers and move each along its ray by the
     range-scaled SDF: z_surf = z + tsdf * truncation / (range / z);
  3. z-buffer: each pixel takes the splat with the smallest 13-bit
     quantized depth over [min_depth, max_depth], ties going to the
     earliest splat in [V2, 512] order, and carries that splat's exact
     depth and colour. The JAX package sorts a uint32 (pixel << 13 |
     depth) key with a stable sort; here one `scatter_reduce(amin)` of
     the valid splats' int64 (depth << 32 | splat) keys per pixel picks
     the same winner with no sort and no limit on the pixel count;
  4. normals from central differences of the back-projected depth image
     (`torch.roll`, wrapping at the edges as `jnp.roll` does), diffuse
     shading and the semantic red-alpha overlay.

Returns the JAX function's dict: `depth`, `rgba`, `normal`, `hit`,
`dropped_splats`.
"""

from __future__ import annotations

import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera, to_i32
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.map.blocks import BLOCK_LEN, unpack_block_coords, voxel_offsets
from ra_slam_tpu_torch.map.voxel_map import VoxelMap, _div, _rank, _sqrt, visible_blocks

ZBITS = 13
_ZMAX = (1 << ZBITS) - 1


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis of length 3, summed in order and
    correctly rounded, as `jnp.linalg.norm` on the CPU."""
    s = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    n = _sqrt(s)
    return n[..., None] if keepdim else n


def _pixel_dirs(cam: PinholeCamera, device):
    """((u - cx) / fx [1, W], (v - cy) / fy [H, 1]) float32."""
    u = torch.arange(cam.width, dtype=torch.float32, device=device)[None, :]
    v = torch.arange(cam.height, dtype=torch.float32, device=device)[:, None]
    return _div(u - cam.cx, cam.fx), _div(v - cam.cy, cam.fy)


def _screen_space_normals(depth: torch.Tensor, hit: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """Camera-frame unit normals [H, W, 3] from central differences of
    the back-projected depth image, 0 where a neighbour is missing.
    Neighbours wrap around the image edges (`jnp.roll`)."""
    xn, yn = _pixel_dirs(cam, depth.device)
    P = torch.stack([xn * depth, yn * depth, depth], dim=-1)

    def shift(a, du, dv):
        return torch.roll(a, shifts=(-dv, -du), dims=(0, 1))

    dPdu = shift(P, 1, 0) - shift(P, -1, 0)
    dPdv = shift(P, 0, 1) - shift(P, 0, -1)
    n = torch.linalg.cross(dPdv, dPdu, dim=-1)
    n = n / torch.clamp(_norm(n, keepdim=True), min=1e-9)
    flip = (n * P).sum(dim=-1, keepdim=True) > 0  # orient toward the camera
    n = torch.where(flip, -n, n)
    valid = hit & shift(hit, 1, 0) & shift(hit, -1, 0) & shift(hit, 0, 1) & shift(hit, 0, -1)
    return torch.where(valid[..., None], n, 0.0)


def _splats(m: VoxelMap, cam: PinholeCamera, cam_T_world: SE3, cfg: TsdfConfig, shell: float,
            max_shell_blocks: int):
    """Stages 1-2: (pix [S] int64 with n_pix for invalid splats, z_surf
    [S] float32, attr [S] int64 packed r<<24|g<<16|b<<8|p, dropped) for
    the S = V2 * 512 splats in [V2, 512] order."""
    dev = m.device
    H, W = cam.height, cam.width
    n_pix = H * W

    vis_idx, vis_mask, _ = visible_blocks(m, cam, cam_T_world, cfg)
    vis_l = vis_idx.long()
    tsdf_vis = m.tsdf[vis_l]  # [V, 512]
    w_vis = m.weight[vis_l]
    shell_voxel = (tsdf_vis.abs() < shell) & (w_vis >= cfg.raycast_min_weight)
    has = vis_mask & shell_voxel.any(dim=1)
    V2 = max_shell_blocks or max(1, cfg.max_visible_blocks // 2)
    rank = _rank(has)
    keep = has & (rank < V2)
    dest = rank[keep].long()
    sel = torch.full((V2,), -1, dtype=torch.int32, device=dev)
    sel[dest] = vis_idx[keep]
    vrow = torch.zeros((V2,), dtype=torch.long, device=dev)
    vrow[dest] = torch.nonzero(keep).squeeze(1)
    dropped = torch.clamp(has.sum(dtype=torch.int32) - V2, min=0) * 512

    bmask = sel >= 0
    selc = torch.clamp(sel, min=0).long()
    tsdf = tsdf_vis[vrow]  # [V2, 512]
    weight = w_vis[vrow]
    rgb = m.rgb[selc]  # [V2, 3, 512]
    prob = m.prob[selc]

    base = unpack_block_coords(m.block_key[selc])  # [V2, 3]
    pts = (
        base[:, None, :].to(torch.float32) * BLOCK_LEN
        + voxel_offsets(dev)[None].to(torch.float32)
        + 0.5
    ) * cfg.voxel_size
    q = cam_T_world.apply(pts)  # [V2, 512, 3] camera frame
    uv, z = cam.project(q)
    d2r = _norm(q) / torch.clamp(z, min=1e-9)
    z_surf = z + tsdf * cfg.truncation / d2r

    ui = to_i32(torch.round(uv[..., 0]))  # half to even, as jnp.round
    vi = to_i32(torch.round(uv[..., 1]))
    valid = (
        bmask[:, None]
        & (weight >= cfg.raycast_min_weight)
        & (tsdf.abs() < shell)
        & (z > 0.0)
        & (z_surf > cfg.min_depth)
        & (z_surf <= cfg.max_depth)
        & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    )
    pix = torch.where(valid, vi.long() * W + torch.clamp(ui, 0, W - 1), n_pix).reshape(-1)
    z_flat = torch.where(valid, z_surf, torch.inf).reshape(-1)

    def q8(a):
        return torch.clamp(a, 0, 255).to(torch.int64)

    c = q8(rgb)
    attr = ((c[:, 0] << 24) | (c[:, 1] << 16) | (c[:, 2] << 8) | q8(prob * 255.0)).reshape(-1)
    return pix, z_flat, attr, dropped


def raycast(
    m: VoxelMap,
    cam: PinholeCamera,
    cam_T_world: SE3,
    cfg: TsdfConfig,
    shell: float = 0.5,
    max_shell_blocks: int | None = None,
) -> dict:
    """Render the map from a virtual camera.

    Returns 'depth' [H, W] (z-depth, 0 = miss), 'rgba' [H, W, 4]
    (uint8-range float: shaded colour with the semantic overlay, alpha
    255 at hits), 'normal' [H, W, 3] (camera frame), 'hit' [H, W] bool and
    'dropped_splats' (int32: 512 per shell block beyond the cap, 0 in a
    healthy render), all on the map's device."""
    if max_shell_blocks is None:
        max_shell_blocks = cfg.max_shell_blocks
    dev = m.device
    H, W = cam.height, cam.width
    n_pix = H * W
    pix, z_flat, attr, dropped = _splats(m, cam, cam_T_world, cfg, shell, max_shell_blocks)

    # the winner per pixel: smallest quantized depth, then earliest splat.
    # Only valid splats enter the scatter: sending the invalid ones (most
    # of them) to one spare slot serialized their atomics on it.
    live = torch.nonzero(pix < n_pix).squeeze(1)
    zq = torch.clamp(
        _div((z_flat[live] - cfg.min_depth) * _ZMAX, cfg.max_depth - cfg.min_depth), 0, _ZMAX
    ).to(torch.int64)
    best = torch.full((n_pix,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, pix[live], (zq << 32) | live, "amin")
    hit_flat = best != torch.iinfo(torch.int64).max
    win = torch.where(hit_flat, best & 0xFFFFFFFF, 0)
    depth = torch.where(hit_flat, z_flat[win], 0.0).reshape(H, W)
    a = torch.where(hit_flat, attr[win], 0).reshape(H, W)
    hit = hit_flat.reshape(H, W)

    color = torch.stack([(a >> 24) & 0xFF, (a >> 16) & 0xFF, (a >> 8) & 0xFF], dim=-1).to(torch.float32)
    pr = _div((a & 0xFF).to(torch.float32), 255.0)
    normal = _screen_space_normals(depth, hit, cam)

    # diffuse shading + semantic red-alpha overlay
    xn, yn = _pixel_dirs(cam, dev)
    dirs = torch.stack([xn.expand(H, W), yn.expand(H, W), torch.ones((H, W), device=dev)], dim=-1)
    dirs = dirs / _norm(dirs, keepdim=True)
    diffuse = (normal * dirs).sum(dim=-1).abs()
    diffuse = torch.where(hit & (diffuse == 0), 1.0, diffuse)  # isolated splats: flat
    shaded = color * diffuse[..., None]
    alpha = torch.clamp((pr - 0.5) * 2.0, 0.0, 1.0)[..., None]
    red = torch.tensor([255.0, 0.0, 0.0], device=dev)
    overlaid = shaded * (1 - alpha) + red * alpha
    hitf = hit.to(torch.float32)[..., None]
    return {
        "depth": depth,
        "rgba": torch.cat([overlaid * hitf, hitf * 255.0], dim=-1),
        "normal": normal * hitf,
        "hit": hit,
        "dropped_splats": dropped,
    }
