"""Dense census stereo in plain float32 PyTorch: the depth a ZED's depth
engine gives, as `features/stereo.py:dense_stereo_depth` states its
semantics. Nothing here imports the program; it shares none of its
helpers.

For a rectified pair of gray images (float32 [H, W]) and D =
`max_disparity`:

1. gray: ITU-R BT.601 luma of an RGB image in float32, 0.299 r + 0.587 g
   + 0.114 b summed in that order.
2. census, radius r: bit k of a pixel's descriptor is set where its k-th
   neighbour of the (2r+1) x (2r+1) window (row-major, centre skipped) is
   darker than it; a neighbour beyond a border is the pixel on the
   opposite side (the image wraps around, as `jnp.roll`).
3. cost(v, d, u): the bits in which the left descriptor at (v, u) and the
   right one at (v, max(u - d, 0)) differ, counted one bit at a time;
   1e9 where u - d < 0.
4. aggregation: at each d, the sum of the costs in the `block` x `block`
   window around (v, u), zero beyond the image.
5. selection: best = the least d of least aggregated cost (the first
   minimum), c0 its cost; unique where c0 * uniqueness < the least cost
   over the d with |d - best| > 1. The right view's cost at (v, d, u_r)
   is the aggregated cost at (v, d, min(u_r + d, W - 1)); the check holds
   where the right view's best at u_r = max(u - best, 0) is within 1 of
   best. Parabola: m = best clamped to [1, D - 2]; lo, c, hi the costs at
   m - 1, m, m + 1; denom = lo + hi - 2 c; offset = 0.5 (lo - hi) /
   max(denom, 1e-6) where |denom| > 1e-6, else 0, clamped to [-0.5, 0.5];
   disparity = best + offset; depth = fxb / max(disparity, 1e-6) (a
   division of tensors). Valid where best > 0, unique, the check holds,
   min_depth < depth < max_depth and u >= D; depth 0 elsewhere.

Row blocks of `rows` rows are computed apart, with the `block // 2` rows
of costs above and below them that their windows need, so that an HD720
pair at D = 192 fits beside the program's map on a card.
`agg_dtype=torch.bfloat16` is the control: each aggregated cost rounded
to bfloat16 before the selection.

Departures: the aggregation sums rows first, then columns, one window
offset after another. Away from the 1e9 costs the sums are of integers
of at most 81 x 24 and exact in float32, in any order. A window that
reaches a 1e9 cost (columns u < D + block // 2, near the left border)
sums in an order-dependent way (a float32 ulp at 1e9 is 64), so there
the second-best cost, the parabola's neighbours and the right view's
costs may part from another order's by a few ulps; such columns are
invalid (u < D) or feed the left-right check of columns up to about
2 D + block, where validity may then differ.
"""

from __future__ import annotations

import torch

SENTINEL = 1e9


def gray(rgb: torch.Tensor) -> torch.Tensor:
    """[H, W] float32 luma of a [H, W, 3] image (0..255)."""
    x = rgb.float()
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def census(img: torch.Tensor, radius: int) -> torch.Tensor:
    """[H, W] int32 descriptors of a [H, W] float32 image."""
    H, W = img.shape
    out = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    rows = torch.arange(H, device=img.device)
    cols = torch.arange(W, device=img.device)
    bit = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            nb = img[(rows + dy) % H][:, (cols + dx) % W]
            out += (nb < img).to(torch.int32) * (1 << bit)
            bit += 1
    return out


def _costs(cl: torch.Tensor, cr: torch.Tensor, D: int, nbits: int) -> torch.Tensor:
    """float32 [R, D, W] Hamming costs of R rows of descriptors."""
    R, W = cl.shape
    u = torch.arange(W, device=cl.device)
    d = torch.arange(D, device=cl.device)
    src = u[None, :] - d[:, None]  # [D, W]
    x = cl[:, None, :] ^ cr[:, src.clamp(min=0)]
    cost = torch.zeros(x.shape, dtype=torch.int32, device=cl.device)
    for k in range(nbits):
        cost += (x >> k) & 1
    return torch.where(src[None] >= 0, cost.float(), torch.tensor(SENTINEL, device=cl.device))


def _window_sums(cost: torch.Tensor, top: int, bottom: int, half: int) -> torch.Tensor:
    """Box sums of the middle rows of `cost` [R, D, W], whose first `top`
    and last `bottom` rows are the halo (fewer than `half` where the image
    ends: zeros stand in)."""
    R, D, W = cost.shape
    z = lambda n: torch.zeros((n, D, W), dtype=cost.dtype, device=cost.device)
    padded = torch.cat([z(half - top), cost, z(half - bottom)])
    n = R - top - bottom
    rows = torch.zeros((n, D, W), dtype=cost.dtype, device=cost.device)
    for i in range(2 * half + 1):
        rows = rows + padded[i:i + n]
    cols = torch.cat([torch.zeros((n, D, half), dtype=cost.dtype, device=cost.device), rows,
                      torch.zeros((n, D, half), dtype=cost.dtype, device=cost.device)], dim=2)
    out = torch.zeros_like(rows)
    for j in range(2 * half + 1):
        out = out + cols[..., j:j + W]
    return out


def _first_min(cost: torch.Tensor, dim: int) -> torch.Tensor:
    """The least index of the least value along `dim`."""
    n = cost.shape[dim]
    shape = [1] * cost.dim()
    shape[dim] = n
    idx = torch.arange(n, device=cost.device).reshape(shape)
    low = cost.amin(dim=dim, keepdim=True)
    return torch.where(cost == low, idx, n).amin(dim=dim)


def _select(agg, fxb, D, min_depth, max_depth, uniqueness):
    """(depth, valid) [R, W] of aggregated costs [R, D, W]."""
    R, _, W = agg.shape
    dev = agg.device
    u = torch.arange(W, device=dev)
    d = torch.arange(D, device=dev)
    best = _first_min(agg, 1)  # [R, W]
    at = lambda k: torch.gather(agg, 1, k[:, None, :])[:, 0, :]
    c0 = at(best)
    far = (d[None, :, None] - best[:, None, :]).abs() > 1
    second = torch.where(far, agg, torch.tensor(float("inf"), device=dev)).amin(dim=1)
    unique = c0 * uniqueness < second

    right = torch.gather(agg, 2, (u[None, :] + d[:, None]).clamp(max=W - 1)[None].expand(R, D, W))
    best_r = _first_min(right, 1)  # [R, W], at the right view's columns
    ur = (u[None, :] - best).clamp(min=0)
    checked = (torch.gather(best_r, 1, ur) - best).abs() <= 1

    m = best.clamp(1, D - 2)
    lo, c, hi = at(m - 1), at(m), at(m + 1)
    denom = lo + hi - 2.0 * c
    offset = torch.where(denom.abs() > 1e-6, 0.5 * (lo - hi) / denom.clamp(min=1e-6), torch.zeros_like(denom))
    disparity = best.float() + offset.clamp(-0.5, 0.5)
    depth = torch.tensor(fxb, dtype=torch.float32, device=dev) / disparity.clamp(min=1e-6)
    valid = (best > 0) & unique & checked & (depth > min_depth) & (depth < max_depth) & (u[None, :] >= D)
    return torch.where(valid, depth, torch.zeros_like(depth)), valid


def depth(gray_l: torch.Tensor, gray_r: torch.Tensor, focal_x_baseline: float, max_disparity: int, block: int = 9,
          census_radius: int = 2, min_depth: float = 0.1, max_depth: float = 40.0, uniqueness: float = 1.1,
          rows: int = 64, agg_dtype=torch.float32):
    """(depth [H, W] float32 metres, 0 where invalid; valid [H, W] bool)
    of a rectified pair of gray images."""
    H, W = gray_l.shape
    D, half = max_disparity, block // 2
    nbits = (2 * census_radius + 1) ** 2 - 1
    cl, cr = census(gray_l, census_radius), census(gray_r, census_radius)
    out_d = torch.zeros((H, W), dtype=torch.float32, device=gray_l.device)
    out_v = torch.zeros((H, W), dtype=torch.bool, device=gray_l.device)
    for r0 in range(0, H, rows):
        r1 = min(r0 + rows, H)
        a, b = max(r0 - half, 0), min(r1 + half, H)
        agg = _window_sums(_costs(cl[a:b], cr[a:b], D, nbits), r0 - a, b - r1, half)
        agg = agg.to(agg_dtype).float()
        out_d[r0:r1], out_v[r0:r1] = _select(agg, focal_x_baseline, D, min_depth, max_depth, uniqueness)
    return out_d, out_v
