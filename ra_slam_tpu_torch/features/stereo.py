"""Stereo depth from rectified image pairs (counterpart of
`ra_slam_tpu/features/stereo.py`).

Keypoint depth: one left patch and one right epipolar strip per keypoint
in a single batched gather, all candidate ZNCC scores as one `[F, D]`
tensor, the best integer disparity refined by a parabola, depth =
fx*baseline / disparity. `sparse_depth_image` scatters the keypoint
depths into an image so stereo frames reuse the RGB-D landmark path.

Dense depth (the ZED camera's depth for the TSDF): `census_transform`
packs the (2r+1)^2 - 1 neighbour comparisons into an int32 descriptor
(24 bits at radius 2; torch has no uint32 shifts on the CPU and no
popcount), `dense_stereo_depth` builds the `[H, D, W]` Hamming cost
volume with one gather and a byte-table popcount, box-sums it over 9x9
windows as `reduce_window`'s zero-padded "SAME" window (9 shifted adds
per axis: sums of at most 81 integers <= 24 are exact in float32, in any
order), then winner-take-all with the uniqueness ratio, the left-right
check and the subpixel parabola. Out-of-range disparities cost 1e9, so a
window that reaches them sums in an order-dependent way (a float32 ulp
at 1e9 is 64): there, near the left border, the second-best cost, the
parabola's neighbours and the right view's costs may differ from JAX's.
Depth divides a tensor by a tensor (torch's `float / tensor` is a
reciprocal and a multiply).

`dense_stereo_depth` reports to `utils/profiling.py:TRACE`: the span
`stereo.dense` around `stereo.census`, `stereo.cost` (the volume and its
popcount), `stereo.aggregate` (the box sums) and `stereo.select`
(winner-take-all, uniqueness, left-right check, parabola, depth), and
the counters `stereo.dense_calls` (`DENSE_CALLS`, depth maps computed)
and `stereo.dense_entries` (`DENSE_ENTRIES`, H * W * D cost-volume
entries, counted from the shapes on the host).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ra_slam_tpu_torch.slam.landmarks import scatter_rows
from ra_slam_tpu_torch.utils.profiling import TRACE

DENSE_CALLS = 0  # depth maps `dense_stereo_depth` computed
DENSE_ENTRIES = 0  # their cost volumes' H * W * D entries
TRACE.expose("stereo.dense_calls", lambda: DENSE_CALLS)
TRACE.expose("stereo.dense_entries", lambda: DENSE_ENTRIES)


def _gather_patches(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor, dy, dx) -> torch.Tensor:
    """img [H, W]; vi/ui [F]; dy [P]; dx [Q] -> patches [F, P, Q]."""
    H, W = img.shape
    vv = torch.clamp(vi[:, None, None] + dy[None, :, None], 0, H - 1)
    uu = torch.clamp(ui[:, None, None] + dx[None, None, :], 0, W - 1)
    return img[vv, uu]


def stereo_keypoint_depth(
    gray_l: torch.Tensor,  # [H, W] float32 rectified left
    gray_r: torch.Tensor,  # [H, W] float32 rectified right
    uv: torch.Tensor,  # [F, 2] left keypoint pixels
    valid: torch.Tensor,  # [F] bool
    focal_x_baseline: float,  # fx * baseline (pixel * meters)
    max_disparity: int = 64,
    patch: int = 7,
    min_zncc: float = 0.6,
    min_depth: float = 0.1,
    max_depth: float = 40.0,
    min_texture: float = 2.0,  # mean |horizontal gradient| gate
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint depth by epipolar ZNCC matching.

    Returns (depth [F] float32, 0 where invalid; valid [F] bool)."""
    H, W = gray_l.shape
    F = uv.shape[0]
    P, D = patch, max_disparity
    half = P // 2
    dev = uv.device
    ar = lambda a, b: torch.arange(a, b, device=dev)

    ui = torch.round(uv[:, 0]).to(torch.int64)
    vi = torch.round(uv[:, 1]).to(torch.int64)
    dx = ar(-half, half + 1)
    left = _gather_patches(gray_l, vi, ui, dx, dx)  # [F, P, P]
    # the right strip covers disparities 0..D-1: u' = u - d
    strip = _gather_patches(gray_r, vi, ui, dx, ar(-half - (D - 1), half + 1))  # [F, P, P+D-1]

    # window d takes strip columns (D-1) + half + dx - d
    cols = (D - 1) + half + dx[None, :] - ar(0, D)[:, None]  # [D, P]
    wins = strip[:, :, cols].movedim(2, 1)  # [F, D, P, P]

    lf = left.reshape(F, 1, P * P)
    rf = wins.reshape(F, D, P * P)
    lm = lf - lf.mean(-1, keepdim=True)
    rm = rf - rf.mean(-1, keepdim=True)
    num = torch.sum(lm * rm, -1)
    den = torch.sqrt(torch.sum(lm * lm, -1) * torch.sum(rm * rm, -1) + 1e-9)
    zncc = num / den  # [F, D]

    best = torch.argmax(zncc, dim=-1)  # [F], the first maximum
    score = torch.gather(zncc, -1, best[:, None])[:, 0]
    # subpixel parabola around the best integer disparity
    y0 = torch.gather(zncc, -1, torch.clamp(best - 1, 0, D - 1)[:, None])[:, 0]
    y2 = torch.gather(zncc, -1, torch.clamp(best + 1, 0, D - 1)[:, None])[:, 0]
    denom = y0 - 2 * score + y2
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (y0 - y2) / denom, 0.0)
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    depth = focal_x_baseline / torch.clamp(disp, min=1e-3)
    # aperture gate: without horizontal texture every shift matches
    h_grad = torch.mean((left[:, :, 1:] - left[:, :, :-1]).abs(), dim=(1, 2))
    ok = (
        valid
        & (h_grad >= min_texture)
        & (score >= min_zncc)
        & (best > 0)
        & (best < D - 1)
        & (depth > min_depth)
        & (depth < max_depth)
        # the strip must not have been clipped at the image border
        & (ui - (best + half) >= 0)
        & (ui + half < W)
        & (vi - half >= 0)
        & (vi + half < H)
    )
    return torch.where(ok, depth, 0.0), ok


def sparse_depth_image(
    uv: torch.Tensor,  # [F, 2]
    depth: torch.Tensor,  # [F]
    valid: torch.Tensor,  # [F] bool
    height: int,
    width: int,
) -> torch.Tensor:
    """Per-keypoint depths scattered into a [H, W] image (0 elsewhere;
    where two keypoints round to one pixel the later one wins)."""
    ui = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, width - 1)
    vi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, height - 1)
    img = torch.zeros(height * width, dtype=torch.float32, device=uv.device)
    return scatter_rows(img, vi * width + ui, depth, valid).reshape(height, width)


# ---------------------------------------------------------------------------
# Dense stereo depth (the ZED-SDK dense-disparity role)
# ---------------------------------------------------------------------------

COST_SENTINEL = 1e9  # the cost of a disparity beyond the left border


def census_transform(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """[H, W] -> [H, W] int32 census descriptor: bit k set iff the k-th
    neighbour (in a (2r+1)^2 window, centre excluded, row-major) is
    darker than the centre; the borders wrap as `jnp.roll`'s."""
    nbits = (2 * radius + 1) ** 2 - 1
    if nbits > 31:
        raise ValueError(f"census radius {radius} needs {nbits} bits; int32 descriptors hold 31")
    bits = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    k = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            shifted = torch.roll(img, (-dy, -dx), dims=(0, 1))
            bits = bits | ((shifted < img).to(torch.int32) << k)
            k += 1
    return bits


_POPCOUNT_TABLES: dict = {}  # device -> the 256-entry byte table there


def _popcount_table(device) -> torch.Tensor:
    table = _POPCOUNT_TABLES.get(device)
    if table is None:
        table = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.uint8, device=device)
        _POPCOUNT_TABLES[device] = table
    return table


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 values below 2^24, as uint8 (three
    lookups in a byte table made once per device)."""
    table = _popcount_table(x.device)
    return table[x & 0xFF] + table[(x >> 8) & 0xFF] + table[(x >> 16) & 0xFF]


def _box_sum(cost: torch.Tensor, half: int) -> torch.Tensor:
    """`reduce_window(cost, 0, add, (2h+1, 1, 2h+1), (1, 1, 1), "SAME")`
    of an [H, D, W] volume: zero padding, one axis after the other."""
    H, _, W = cost.shape
    p = torch.nn.functional.pad(cost, (half, half, 0, 0, half, half))
    rows = p[: H]
    for i in range(1, 2 * half + 1):
        rows = rows + p[i: i + H]
    out = rows[..., :W]
    for j in range(1, 2 * half + 1):
        out = out + rows[..., j: j + W]
    return out


def dense_stereo_depth(
    gray_l: torch.Tensor,  # [H, W] float32 rectified left
    gray_r: torch.Tensor,  # [H, W] float32 rectified right
    focal_x_baseline: float,  # fx * baseline (pixel * meters)
    max_disparity: int = 64,
    block: int = 9,
    census_radius: int = 2,
    min_depth: float = 0.1,
    max_depth: float = 40.0,
    uniqueness: float = 1.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense disparity -> depth map of a rectified pair: census, the
    [H, D, W] Hamming cost volume, 9x9 box aggregation, winner-take-all
    with the left-right check, the uniqueness ratio and the subpixel
    parabola. Returns (depth [H, W] float32, 0 where invalid; valid
    [H, W] bool)."""
    global DENSE_CALLS, DENSE_ENTRIES
    H, W = gray_l.shape
    D = max_disparity
    dev = gray_l.device
    DENSE_CALLS += 1
    DENSE_ENTRIES += H * W * D
    with TRACE.span("stereo.dense"):
        with TRACE.span("stereo.census"):
            cl = census_transform(gray_l, census_radius)
            cr = census_transform(gray_r, census_radius)
        u = torch.arange(W, device=dev)
        d = torch.arange(D, device=dev)
        with TRACE.span("stereo.cost"):
            uc = torch.clamp(u[None, :] - d[:, None], 0, W - 1)  # right column of (d, u)
            cost = _popcount(cl[:, None, :] ^ cr[:, uc]).to(torch.float32)  # [H, D, W]
            inb = (u[None, :] - d[:, None]) >= 0
            cost = torch.where(inb[None], cost, COST_SENTINEL)
        with TRACE.span("stereo.aggregate"):
            agg = _box_sum(cost, block // 2)  # [H, D, W]
        del cost
        with TRACE.span("stereo.select"):
            return _select(agg, u, d, focal_x_baseline, min_depth, max_depth, uniqueness)


def _left_right_ok(agg: torch.Tensor, u: torch.Tensor, d: torch.Tensor, best_d: torch.Tensor) -> torch.Tensor:
    """Left-right consistency: the matched right pixel's own best
    disparity is within 1 of the left pixel's (right-view cost at (d, v,
    u_r) = left cost at column u_r + d)."""
    H, D, W = agg.shape
    ul = torch.clamp(u[None, :] + d[:, None], 0, W - 1)  # [D, W]
    right_cost = torch.gather(agg, 2, ul[None].expand(H, D, W))  # [H, D, W]
    best_r = torch.argmin(right_cost, dim=1)
    del right_cost
    ur = torch.clamp(u[None, :] - best_d, 0, W - 1)
    return (torch.gather(best_r, 1, ur) - best_d).abs() <= 1


def _select(agg, u, d, focal_x_baseline, min_depth, max_depth, uniqueness):
    """Winner-take-all over an aggregated [H, D, W] volume, with the
    uniqueness ratio, the left-right check and the subpixel parabola:
    (depth [H, W], 0 where invalid; valid [H, W])."""
    D = agg.shape[1]

    best_d = torch.argmin(agg, dim=1)  # [H, W], the first minimum
    ar = agg.movedim(1, -1)  # [H, W, D]
    c0 = torch.gather(ar, -1, best_d[..., None])[..., 0]
    # uniqueness: the best must beat the best outside +-1 by the ratio
    near = (d[None, None, :] - best_d[..., None]).abs() <= 1
    second = torch.where(near, COST_SENTINEL, ar).amin(dim=-1)
    uniq_ok = c0 * uniqueness < second

    lr_ok = _left_right_ok(agg, u, d, best_d)

    # subpixel parabola on the aggregated cost
    dm = torch.clamp(best_d, 1, D - 2)
    lo = torch.gather(ar, -1, (dm - 1)[..., None])[..., 0]
    hi = torch.gather(ar, -1, (dm + 1)[..., None])[..., 0]
    cc = torch.gather(ar, -1, dm[..., None])[..., 0]
    denom = lo + hi - 2.0 * cc
    off = torch.where(denom.abs() > 1e-6, 0.5 * (lo - hi) / torch.clamp(denom, min=1e-6), 0.0)
    disp = best_d.to(torch.float32) + torch.clamp(off, -0.5, 0.5)

    depth = torch.full_like(disp, focal_x_baseline) / torch.clamp(disp, min=1e-6)
    valid = (
        (best_d > 0)
        & uniq_ok
        & lr_ok
        & (depth > min_depth)
        & (depth < max_depth)
        & (u[None, :] >= D)  # the full search range is available
    )
    return torch.where(valid, depth, 0.0), valid
