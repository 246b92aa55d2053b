"""FAST-9/16 corner detection on whole images (counterpart of
`ra_slam_tpu/features/fast.py`).

Every pixel's 16-pixel Bresenham circle is read from 16 shifted copies
of the image; a corner needs >= 9 contiguous circle pixels all brighter
(or all darker) than centre +- threshold.

Selection keeps `jax.lax.top_k`'s order: values descending, ties toward
the lower index. `torch.topk` promises no order among ties, and the
score maps are mostly zeros (and the cell keys mostly -inf), so the port
takes a stable descending sort and slices it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (the standard FAST-16 ring, clockwise).
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 9
BORDER = 3


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last dim: the k largest, descending, ties
    broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _ring_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum of the 16 ring terms [16, H, W] in ring order, as XLA's CPU
    reduce sums them. Neighbouring pixels' scores often tie exactly, and
    non-maximum suppression keeps both of a tie, so the order decides
    keypoints; a CUDA reduction interleaves its accumulators."""
    acc = terms[0]
    for k in range(1, terms.shape[0]):
        acc = acc + terms[k]
    return acc


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """[H, W] corner score: 0 for non-corners, else the sum of absolute
    differences beyond the threshold (OpenCV-style V score)."""
    H, W = img.shape
    ring = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)) for dx, dy in _CIRCLE])
    center = img[None]
    bright = ring > center + threshold
    dark = ring < center - threshold

    def has_arc(mask):
        run = mask
        for k in range(1, ARC):
            run = run & torch.roll(mask, -k, dims=0)
        return run.any(dim=0)

    is_corner = has_arc(bright) | has_arc(dark)
    db = _ring_sum(torch.where(bright, ring - center - threshold, 0.0))
    dd = _ring_sum(torch.where(dark, center - threshold - ring, 0.0))
    score = torch.maximum(db, dd)

    u = torch.arange(W, device=img.device)[None, :]
    v = torch.arange(H, device=img.device)[:, None]
    inb = (u >= BORDER) & (u < W - BORDER) & (v >= BORDER) & (v < H - BORDER)
    return torch.where(is_corner & inb, score, 0.0)


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (`reduce_window` max with SAME padding
    of -inf, which is `max_pool2d`'s padding)."""
    neigh = F.max_pool2d(score[None, None], 3, 1, 1)[0, 0]
    return torch.where(score >= neigh, score, 0.0)


def _cell_select(s: torch.Tensor, max_corners: int, cell: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell top-k, then the best of every cell ahead of any cell's
    second-best (rank-major). Returns (vals [K], flat_idx [K])."""
    H, W = s.shape
    Hp = ((H + cell - 1) // cell) * cell
    Wp = ((W + cell - 1) // cell) * cell
    sp = F.pad(s, (0, Wp - W, 0, Hp - H))
    gy, gx = Hp // cell, Wp // cell
    ncells = gy * gx
    cells = sp.reshape(gy, cell, gx, cell).permute(0, 2, 1, 3).reshape(ncells, cell * cell)
    k_cell = min(max(4 * max_corners // max(ncells, 1), 1), cell * cell)
    cv, ci = top_k(cells, k_cell)  # [ncells, k_cell]
    cid = torch.arange(ncells, device=s.device)[:, None]
    py = (cid // gx) * cell + ci // cell
    px = (cid % gx) * cell + ci % cell
    inb = (py < H) & (px < W)
    flat = torch.where(inb, py * W + px, 0)
    cv = torch.where(inb, cv, 0.0)
    rank = torch.arange(k_cell, dtype=torch.float32, device=s.device)[None].expand_as(cv)
    key = torch.where(cv > 0.0, cv - rank * 1e7, float("-inf"))
    keyvals, order = top_k(key.reshape(-1), max_corners)
    vals = torch.where(torch.isfinite(keyvals), cv.reshape(-1)[order], 0.0)
    return vals, flat.reshape(-1)[order]


def _cell_has_corner(raw: torch.Tensor, cell: int) -> torch.Tensor:
    """[H, W] bool: the (cell x cell) window of `reduce_window(max,
    stride=cell, "SAME")` holds a positive score, spread back over
    `cell`-sized blocks from the origin. SAME splits its padding between
    both sides, so each window sits shifted by the low pad, as in the
    JAX package."""
    H, W = raw.shape
    pads = []
    for n in (W, H):
        out = (n + cell - 1) // cell
        total = max((out - 1) * cell + cell - n, 0)
        pads += [total // 2, total - total // 2]
    pooled = F.max_pool2d(F.pad(raw, pads)[None, None], cell, cell)[0, 0]
    has = (pooled > 0.0).repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    return has[:H, :W]


def fast_corners(
    img: torch.Tensor,
    threshold: float,
    max_corners: int,
    min_threshold: float = 0.0,
    cell_size: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to `max_corners` FAST corners on one image: (uv [K, 2] float32,
    score [K], valid [K] bool), fixed K. Cells (of `cell_size`, or the
    whole image) with no corner at `threshold` fall back to
    `min_threshold`; with `cell_size` > 0 selection is per cell. Corners
    get a subpixel parabola fit on the raw score."""
    H, W = img.shape
    raw = fast_score(img, threshold)
    if 0.0 < min_threshold < threshold:
        raw_min = fast_score(img, min_threshold)
        cell = cell_size if cell_size > 0 else max(H, W)
        raw = torch.where(_cell_has_corner(raw, cell), raw, raw_min)
    s = _nms3(raw)
    if cell_size > 0:
        vals, idx = _cell_select(s, max_corners, cell_size)
    else:
        vals, idx = top_k(s.reshape(-1), max_corners)
    ui = idx % W
    vi = idx // W
    valid = vals > 0.0

    uc = torch.clamp(ui, 1, W - 2)
    vc = torch.clamp(vi, 1, H - 2)
    c = raw[vc, uc]
    du = _parabola_offset(raw[vc, uc - 1], c, raw[vc, uc + 1])
    dv = _parabola_offset(raw[vc - 1, uc], c, raw[vc + 1, uc])
    u = ui.to(torch.float32) + torch.where(valid, du, 0.0)
    v = vi.to(torch.float32) + torch.where(valid, dv, 0.0)
    return torch.stack([u, v], dim=-1), vals, valid


def _parabola_offset(lo: torch.Tensor, c: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Vertex offset in [-0.5, 0.5] of the parabola through (-1,lo),(0,c),(1,hi)."""
    denom = 2.0 * c - lo - hi
    off = torch.where(
        denom.abs() > 1e-6, 0.5 * (hi - lo) / torch.clamp(denom, min=1e-6), 0.0
    )
    return torch.clamp(off, -0.5, 0.5)
