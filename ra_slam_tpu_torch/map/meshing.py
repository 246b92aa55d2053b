"""Isosurface mesh extraction from the TSDF map by marching tetrahedra
(counterpart of `ra_slam_tpu/map/meshing.py`).

Each lattice cube splits into 6 tetrahedra around its main diagonal and
each tetrahedron triangulates from a 16-case table. Per chunk of active
blocks (in pool order):

  1. gather each block's [9, 9, 9] halo grid of tsdf, prob and weight
     (its own 8x8x8 voxels plus the first plane of its 7 upper
     neighbours, found by hash lookup; missing neighbours read tsdf 1,
     prob 0.5, weight 0, so their cubes do not emit);
  2. classify every (cube, tetrahedron) and keep the triangles of cubes
     whose 8 corners all reach `min_weight`, in the JAX package's stream
     order: blocks in pool order, then [cube (x slowest), tetrahedron,
     triangle] (`torch.nonzero` keeps it);
  3. per kept vertex, the canonical edge words of the JAX package
     (`_pack_edge_words`: the lattice edge as a (hi, lo) pair of 32-bit
     words) and aux = u16(u) << 16 | u16(prob), the interpolation
     parameter measured from the canonical endpoint and the interpolated
     probability.

Then the shared vertices are merged by their edge key, numbered in order
of first use in the triangle stream, decoded to positions, and quantized
to u16 over the mesh's bounding box as the JAX package's transfer does,
so that the three `.bin` dumps of both packages hold the same values.
The JAX package's select-sum table lookups, its triangle census, its
fixed-size append buffers and its i16-delta index transfer are TPU
mechanics and are not reproduced: here tables are indexed, compaction is
exact, and the int32 indices move as they are.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.map.blocks import BLOCK_LEN, pack_block_coords, unpack_block_coords
from ra_slam_tpu_torch.map.hash_table import ht_lookup
from ra_slam_tpu_torch.map.voxel_map import VoxelMap, _div

# Cube corners: bit0 -> +x, bit1 -> +y, bit2 -> +z.
_CORNER_OFFS = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int64)

# Six tetrahedra sharing the 0-7 main diagonal.
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int64
)

# Tet edges as (corner, corner) index pairs into the tet's 4 corners.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)

# For each inside-bitmask (bit i = tet corner i has tsdf < 0), up to two
# triangles of tet-edge ids (-1 = unused): one corner apart -> one
# triangle of its three edges; two and two -> the quad across the four
# separating edges, as two triangles.
_TET_TRIS = np.array(
    [
        [[-1, -1, -1], [-1, -1, -1]],  # 0000
        [[0, 1, 2], [-1, -1, -1]],     # 0001 a
        [[0, 3, 4], [-1, -1, -1]],     # 0010 b
        [[1, 2, 4], [1, 4, 3]],        # 0011 ab
        [[1, 3, 5], [-1, -1, -1]],     # 0100 c
        [[0, 2, 5], [0, 5, 3]],        # 0101 ac
        [[0, 5, 1], [0, 4, 5]],        # 0110 bc
        [[2, 5, 4], [-1, -1, -1]],     # 0111 abc
        [[2, 4, 5], [-1, -1, -1]],     # 1000 d
        [[0, 1, 5], [0, 5, 4]],        # 1001 ad
        [[0, 5, 2], [0, 3, 5]],        # 1010 bd
        [[1, 5, 3], [-1, -1, -1]],     # 1011 abd
        [[1, 4, 2], [1, 3, 4]],        # 1100 cd
        [[0, 4, 3], [-1, -1, -1]],     # 1101 acd
        [[0, 2, 1], [-1, -1, -1]],     # 1110 bcd
        [[-1, -1, -1], [-1, -1, -1]],  # 1111
    ],
    np.int64,
)
_TET_TRI_COUNT = (_TET_TRIS[:, :, 0] >= 0).sum(axis=1)  # [16]

_NBR_OFFS = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int32
)

# per (tet, tet-edge): the cube corners at the edge's two ends
_EA_CORNER = _TETS[np.arange(6)[:, None], _TET_EDGES[:, 0][None, :]]  # [6, 6]
_EB_CORNER = _TETS[np.arange(6)[:, None], _TET_EDGES[:, 1][None, :]]

_OFF = 1 << 18  # offset-binary bias of the 19-bit lattice coordinates
_U32 = 0xFFFFFFFF
_Q16 = 65535.0


def _q16(v: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> round-half-up u16 steps (int64), as the JAX package."""
    return torch.clamp(v * _Q16 + 0.5, 0, _Q16).to(torch.int64)


def _halo_grids(m: VoxelMap, bidx: torch.Tensor, fields):
    """Block coords [B, 3] and, per (field [N, 512], fill), the [B, 9, 9,
    9] halo grid indexed [x, y, z] of blocks bidx [B] (one shared
    7-neighbour hash lookup)."""
    coords = unpack_block_coords(m.block_key[bidx])
    nbr_keys = pack_block_coords(coords[:, None, :] + torch.as_tensor(_NBR_OFFS, device=bidx.device)[None])
    nbr = ht_lookup(m.table, nbr_keys.reshape(-1)).reshape(-1, 7).long()
    ok = nbr >= 0
    nbr = torch.clamp(nbr, min=0)
    B = bidx.shape[0]

    def xyz(rows):  # [..., 512] (idx = x + 8y + 64z) -> [..., x, y, z]
        return rows.reshape(*rows.shape[:-1], BLOCK_LEN, BLOCK_LEN, BLOCK_LEN).transpose(-1, -3)

    grids = []
    for field, fill in fields:
        g = torch.full((B, 9, 9, 9), fill, dtype=field.dtype, device=field.device)
        g[:, :8, :8, :8] = xyz(field[bidx])
        n = torch.where(ok[..., None], field[nbr], fill)  # [B, 7, 512]
        n = xyz(n)  # [B, 7, x, y, z]
        g[:, 8, :8, :8] = n[:, 0, 0, :, :]
        g[:, :8, 8, :8] = n[:, 1, :, 0, :]
        g[:, :8, :8, 8] = n[:, 2, :, :, 0]
        g[:, 8, 8, :8] = n[:, 3, 0, 0, :]
        g[:, 8, :8, 8] = n[:, 4, 0, :, 0]
        g[:, :8, 8, 8] = n[:, 5, :, 0, 0]
        g[:, 8, 8, 8] = n[:, 6, 0, 0, 0]
        grids.append(g)
    return coords, grids


def _corners(g: torch.Tensor) -> torch.Tensor:
    """[B, 9, 9, 9] halo grids -> [B, 512, 8] cube-corner samples, cube
    index x slowest."""
    return torch.stack(
        [g[:, cx:cx + 8, cy:cy + 8, cz:cz + 8] for cx, cy, cz in _CORNER_OFFS.tolist()], dim=-1
    ).reshape(g.shape[0], 512, 8)


def _pack_edge_words(ea: torch.Tensor, eb: torch.Tensor, u: torch.Tensor):
    """Endpoint lattice coords ea/eb [..., 3] int64 + interpolation u
    (from ea) -> the canonical (hi, lo) 32-bit words (held in int64) and
    u re-measured from the canonical endpoint, as the JAX package packs
    them: key = [x:19][y:19][z:19][delta:5] over the two words, so every
    cube incident to an edge emits the same words."""
    a = ea + _OFF
    b = eb + _OFF

    def proxy(e):
        return ((e[..., 0] << 13) ^ (e[..., 1] << 3) ^ e[..., 2]) & _U32

    a_first = proxy(a) <= proxy(b)
    base = torch.where(a_first[..., None], a, b)
    other = torch.where(a_first[..., None], b, a)
    u_c = torch.where(a_first, u, 1.0 - u)
    d = other - base + 1  # {0, 1, 2}
    d5 = d[..., 0] * 9 + d[..., 1] * 3 + d[..., 2]  # < 27
    x, y, z = base[..., 0], base[..., 1], base[..., 2]
    hi = ((x << 13) | (y >> 6)) & _U32
    lo = (((y & 0x3F) << 26) | (z << 7) | d5) & _U32
    return hi, lo, u_c


def edge_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 sort key of the (hi, lo) word pair, ordered as the JAX
    package's two-key uint32 sort orders the pairs. `hi << 32 | lo` would
    go negative for hi >= 2^31 (every non-negative lattice x); with hi's
    top bit flipped, (hi ^ 0x80000000) << 32 | lo read as int64 is
    (hi - 2^31) * 2^32 + lo, so the order holds and the all-ones sentinel
    maps to the largest int64."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def _emit_chunk(m: VoxelMap, bidx: torch.Tensor, min_weight: float, words: bool):
    """Triangles of blocks bidx in stream order: their count and, when
    `words`, the per-vertex (hi, lo, aux) words [T, 3] int64."""
    dev = bidx.device
    coords, (t9, p9, w9) = _halo_grids(m, bidx, [(m.tsdf, 1.0), (m.prob, 0.5), (m.weight, 0.0)])
    ct, cw = _corners(t9), _corners(w9)  # [B, 512, 8]
    cube_ok = (cw >= min_weight).all(dim=-1)  # [B, 512]
    tets = torch.as_tensor(_TETS, device=dev)
    inside = (ct[:, :, tets] < 0).to(torch.int64)  # [B, 512, 6, 4]
    case = inside[..., 0] + 2 * inside[..., 1] + 4 * inside[..., 2] + 8 * inside[..., 3]
    n_tri = torch.as_tensor(_TET_TRI_COUNT, device=dev)[case]  # [B, 512, 6]
    valid = (torch.arange(2, device=dev) < n_tri[..., None]) & cube_ok[:, :, None, None]
    if not words:
        return int(valid.sum()), None
    b, c, t, k = torch.nonzero(valid).unbind(1)  # candidate-major order
    if b.numel() == 0:
        return 0, None

    edges = torch.as_tensor(_TET_TRIS, device=dev)[case[b, c, t], k]  # [T, 3] tet-edge ids
    ea = torch.as_tensor(_EA_CORNER, device=dev)[t[:, None], edges]  # [T, 3] cube corners
    eb = torch.as_tensor(_EB_CORNER, device=dev)[t[:, None], edges]
    cp = _corners(p9)
    ta, tb = ct[b[:, None], c[:, None], ea], ct[b[:, None], c[:, None], eb]
    pa, pb = cp[b[:, None], c[:, None], ea], cp[b[:, None], c[:, None], eb]
    denom = ta - tb
    u = torch.clamp(torch.where(denom.abs() > 1e-9, ta / denom, 0.5), 0.0, 1.0)
    xprob = pa + u * (pb - pa)

    cube = torch.stack([c // 64, (c // 8) % 8, c % 8], dim=-1)  # x slowest
    gx = (coords.to(torch.int64)[b] * BLOCK_LEN + cube)[:, None, :]  # [T, 1, 3]
    corner = torch.as_tensor(_CORNER_OFFS, device=dev)
    hi, lo, u_c = _pack_edge_words(gx + corner[ea], gx + corner[eb], u)
    aux = (_q16(u_c) << 16) | _q16(xprob)
    return b.numel(), (hi, lo, aux)


def _decode_vertices(hi, lo, aux, voxel_size: float):
    """(hi, lo, aux) words -> (x, y, z, prob) float32: the inverse of
    `_pack_edge_words` and the aux quantization."""
    x = hi >> 13
    y = ((hi & 0x1FFF) << 6) | (lo >> 26)
    z = (lo >> 7) & 0x7FFFF
    d5 = lo & 0x7F
    dx, dy, dz = d5 // 9 - 1, (d5 // 3) % 3 - 1, d5 % 3 - 1
    u = _div((aux >> 16).to(torch.float32), _Q16)
    prob = _div((aux & 0xFFFF).to(torch.float32), _Q16)

    def coord(c, dc):
        return ((c - _OFF).to(torch.float32) + u * dc) * voxel_size

    return coord(x, dx), coord(y, dy), coord(z, dz), prob


def _dedup(hi, lo, aux, voxel_size: float):
    """Shared-vertex merge of the [T*3] vertex stream and first-use
    numbering, then decode and u16 quantization over the bounding box.

    Returns (indices [T*3] int64, xq/yq/zq/pq [V] int64, aabb_lo [3],
    aabb_scale [3] float32). A vertex's aux is taken from its LAST use in
    the stream, as the JAX package's scatter of every use leaves it (two
    cubes on one edge may round u one u16 step apart)."""
    n = hi.shape[0]
    dev = hi.device
    uniq, inverse0 = torch.unique(edge_key(hi, lo), return_inverse=True)
    nv = uniq.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    first = torch.full((nv,), n, dtype=torch.int64, device=dev).scatter_reduce_(0, inverse0, pos, "amin")
    last = torch.full((nv,), -1, dtype=torch.int64, device=dev).scatter_reduce_(0, inverse0, pos, "amax")
    order = torch.argsort(first)  # first positions are distinct
    remap = torch.empty_like(order)
    remap[order] = torch.arange(nv, dtype=torch.int64, device=dev)
    indices = remap[inverse0]

    rep = last[order]  # the stream position whose words each vertex keeps
    vx, vy, vz, prob = _decode_vertices(hi[rep], lo[rep], aux[rep], voxel_size)
    cols = torch.stack([vx, vy, vz])  # [3, V]
    aabb_lo = cols.amin(dim=1)
    aabb_scale = torch.clamp(cols.amax(dim=1) - aabb_lo, min=1e-9)
    q = _q16((cols - aabb_lo[:, None]) / aabb_scale[:, None])
    return indices, q[0], q[1], q[2], _q16(prob), aabb_lo, aabb_scale


def extract_mesh(
    m: VoxelMap,
    cfg: TsdfConfig,
    min_weight: float = 1.5,
    chunk: int = 4096,
    max_tris: int = 1 << 23,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The map's isosurface with shared vertices merged.

    Returns numpy (vertices [V, 3] float32, indices [T, 3] int32,
    vertex_probs [V] float32): the layout of the reference's binary mesh
    dump. Positions and probabilities go through the JAX package's u16
    quantization (positions per axis over the bounding box, ~0.1 mm at
    room scale; probabilities in 1/65535 steps), so both packages dump
    the same values; triangles that the merge made degenerate are
    dropped. `chunk` is the number of blocks per step (memory only; the
    result does not depend on it). A surface of more than `max_tris`
    triangles raises ValueError."""
    order = torch.nonzero(m.active).squeeze(1)
    n = 0
    parts = []
    for s in range(0, order.shape[0], chunk):
        cnt, w = _emit_chunk(m, order[s:s + chunk], min_weight, words=n <= max_tris)
        n += cnt
        if w is not None and n <= max_tris:
            parts.append(w)
    if n > max_tris:
        raise ValueError(
            f"mesh overflow: map surface has {n} triangles > "
            f"max_tris={max_tris}; raise the budget or raise min_weight"
        )
    return _mesh_arrays(parts, cfg.voxel_size)


def _mesh_arrays(parts, voxel_size: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge, number and quantize the vertex words of the chunks' parts
    (`_emit_chunk` outputs in stream order); numpy (vertices, indices
    without the degenerate triangles, vertex probs)."""
    if not parts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), np.zeros((0,), np.float32)
    hi, lo, aux = (torch.cat([p[i] for p in parts]).reshape(-1) for i in range(3))
    idx, xq, yq, zq, pq, aabb_lo, aabb_scale = _dedup(hi, lo, aux, voxel_size)

    indices = idx.to(torch.int32).reshape(-1, 3).cpu().numpy()
    lo_h = aabb_lo.cpu().numpy()
    sc_h = aabb_scale.cpu().numpy()
    vertices = np.empty((xq.shape[0], 3), np.float32)
    for k, qk in enumerate((xq, yq, zq)):
        vertices[:, k] = qk.cpu().numpy().astype(np.float32) * (sc_h[k] / 65535.0) + lo_h[k]
    probs = pq.cpu().numpy().astype(np.float32) / 65535.0

    nondeg = (
        (indices[:, 0] != indices[:, 1])
        & (indices[:, 1] != indices[:, 2])
        & (indices[:, 0] != indices[:, 2])
    )
    return vertices, indices[nondeg], probs


def emit_budgeted(m: VoxelMap, min_weight: float, chunk: int, c_max: int, cap: int):
    """The triangles of the map's active blocks in stream order, under a
    per-chunk budget `c_max` and a total budget `cap`: the emission of
    the JAX package's in-program sharded export (`_emit_all_scan`). A
    chunk keeps its first min(count, c_max) triangles while the total
    stays within `cap`; what is cut is counted, never dropped silently.

    Returns (parts for `_mesh_arrays`, triangles kept, triangles cut)."""
    order = torch.nonzero(m.active).squeeze(1)
    parts, kept_total, cut = [], 0, 0
    for s in range(0, order.shape[0], chunk):
        cnt, words = _emit_chunk(m, order[s:s + chunk], min_weight, words=True)
        kept = max(min(cnt, c_max, cap - kept_total), 0)
        if kept:
            parts.append(tuple(w[:kept] for w in words))
        kept_total += kept
        cut += cnt - kept
    return parts, kept_total, cut


def save_mesh(
    vertices: np.ndarray,
    indices: np.ndarray,
    probs: np.ndarray,
    vertices_path: str,
    indices_path: str,
    prob_path: str,
) -> None:
    """Write the reference's binary mesh dump: float32 xyz rows, int32
    index triples, float32 per-vertex probabilities."""
    vertices.astype(np.float32).tofile(vertices_path)
    indices.astype(np.int32).tofile(indices_path)
    probs.astype(np.float32).tofile(prob_path)
