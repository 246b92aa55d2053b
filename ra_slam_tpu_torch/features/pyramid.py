"""Image pyramid + separable Gaussian blur (counterpart of
`ra_slam_tpu/features/pyramid.py`).

Each level is resized from level 0 with `jax.image.resize(method=
"linear")`'s own resampling: a triangle kernel widened by the scale
(antialiasing) and normalised per output sample. Its weight matrices are
built here in numpy the way `jax._src.image.scale.compute_weight_mat`
builds them, once per shape. (`F.interpolate(mode="bilinear",
antialias=True)` resamples differently, by up to 4e-3 of an intensity
level at VGA: enough to flip FAST's threshold tests.)

The JAX package contracts the image with the two weight matrices in one
einsum, rows first where that is cheaper: two matrix products that XLA's
CPU backend sums each in its own order of fused multiply-adds (one chain
along the contracted axis, or interleaved lanes added pairwise, split at
a block start), an order that depends on all three sizes of the product.
A level one float32 step off moves a blurred pixel across a bf16
rounding boundary (BRIEF reads bf16) or breaks a FAST score tie, so the
port sums each output's few nonzero taps in XLA's order (`_XLA_SUMS`,
read off XLA by `scripts/probe_xla_sums.py`), emulating the fused
multiply-add in float64 (the product is exact), on every device alike.
Every level of the pyramids the port builds (640x480 and 672x376 at 8
levels, 320x240 at 4) equals the JAX package's op by op to the bit;
other shapes take one chain, unsplit. The blur adds its products as
XLA's CPU convolution does: in pairs, the pairs in turn.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _gauss_taps(sigma: float, radius: int) -> Tuple[float, ...]:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    # exp correctly rounded to float32, as XLA's is here (numpy's float32
    # exp is an ulp low at -1.125)
    arg = (np.float32(-0.5) * (x / np.float32(sigma)) ** 2).astype(np.float64)
    k = np.exp(arg).astype(np.float32)
    return tuple(float(v) for v in k / k.sum(dtype=np.float32))


def _conv_valid(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """'valid' correlation of x with the (symmetric) taps along `dim`,
    summed as XLA's CPU convolution sums them: the products added in
    pairs, the pairs in turn."""
    n = x.shape[dim] - len(taps) + 1
    terms = [x.narrow(dim, j, n) * k for j, k in enumerate(taps)]
    acc = None
    for j in range(0, len(terms), 2):
        pair = terms[j] + terms[j + 1] if j + 1 < len(terms) else terms[j]
        acc = pair if acc is None else acc + pair
    return acc


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of a [H, W] float image (reflect padding),
    vertical pass first."""
    taps = _gauss_taps(sigma, radius)
    v = F.pad(img[None, None], (0, 0, radius, radius), mode="reflect")[0, 0]
    v = _conv_valid(v, taps, 0)
    h = F.pad(v[None, None], (radius, radius, 0, 0), mode="reflect")[0, 0]
    return _conv_valid(h, taps, 1)


def pyramid_shapes(
    height: int, width: int, num_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    shapes = []
    for lvl in range(num_levels):
        s = scale_factor**lvl
        shapes.append((max(int(round(height / s)), 16), max(int(round(width / s)), 16)))
    return shapes


_SUM_BLOCK = 32


@functools.lru_cache(maxsize=None)
def _weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] float32 resampling weights of `jax.image.resize`'s linear
    method with antialiasing (`compute_weight_mat`, zero translation)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    # column sums in XLA's CPU order: in turn within blocks of 32 rows,
    # the block sums added in turn; where 32 does not divide the rows,
    # the first and the last block share the other 32 + remainder evenly
    # (measured exact at 672, 640, 480, 376, 320, 240, 150 and 120 rows)
    rem = in_size % _SUM_BLOCK
    first = (_SUM_BLOCK + rem) // 2 if rem else _SUM_BLOCK
    edges = [0, *range(first, in_size, _SUM_BLOCK), in_size]
    total = np.zeros((1, out_size), f32)
    for start, stop in zip(edges[:-1], edges[1:]):
        total = total + np.add.reduce(w[start:stop], axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    ).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


# How XLA's CPU dot sums each resampling of the pyramids the port runs
# (640x480 at 8 levels, 672x376 at 8, 320x240 at 4), revealed product by
# product by `scripts/probe_xla_sums.py` against the JAX package op by op
# on an 8-core "Intel(R) Xeon(R) Processor" (lscpu): (in, out, other) ->
# (lanes, block starts), `other` the length of the axis not contracted.
# The contracted axis restarts at each block start; within a block, tap k
# runs in lane (k - start) % lanes, each lane a chain of fused
# multiply-adds; the lanes are added pairwise, ((l0 + l1) + (l2 + l3)),
# and the block sums in turn. Each entry is the fewest lanes and splits
# that give XLA's bits. Other products: one lane, no split.
_XLA_SUMS = {
    # 640x480: the rows, then the columns, of each level
    (480, 400, 640): (1, (240,)), (640, 533, 400): (2, ()),
    (480, 333, 640): (1, ()), (640, 444, 333): (1, (512,)),
    (480, 278, 640): (1, (240,)), (640, 370, 278): (1, (512,)),
    (480, 231, 640): (1, (240,)), (640, 309, 231): (1, (512,)),
    (480, 193, 640): (1, (240,)), (640, 257, 193): (4, ()),
    (480, 161, 640): (1, (240,)), (640, 214, 161): (2, ()),
    (480, 134, 640): (1, (240,)), (640, 179, 134): (1, (512,)),
    # 672x376 (the ZED's VGA mode)
    (376, 313, 672): (1, (192,)), (672, 560, 313): (4, ()),
    (376, 261, 672): (1, (192,)), (672, 467, 261): (2, ()),
    (376, 218, 672): (1, (192,)), (672, 389, 218): (4, ()),
    (376, 181, 672): (1, (192,)), (672, 324, 181): (4, ()),
    (376, 151, 672): (1, (192,)), (672, 270, 151): (4, ()),
    (376, 126, 672): (1, (192,)), (672, 225, 126): (4, ()),
    (376, 105, 672): (1, (192,)), (672, 188, 105): (1, (512,)),
    # 320x240
    (240, 200, 320): (1, ()), (320, 267, 200): (4, ()),
    (240, 167, 320): (1, ()), (320, 222, 167): (2, ()),
    (240, 139, 320): (1, ()), (320, 185, 139): (1, ()),
}


@functools.lru_cache(maxsize=None)
def _lane_taps(in_size: int, out_size: int, other: int) -> Tuple[Tuple[Tuple[np.ndarray, np.ndarray], ...], ...]:
    """Per block, per lane: (idx [T, out] int64, w [T, out] float64), each
    output's taps of that lane in order, padded with zero weights."""
    lanes, starts = _XLA_SUMS.get((in_size, out_size, other), (1, ()))
    wm = _weight_mat(in_size, out_size)
    nz = wm != 0
    first = nz.argmax(0)
    last = in_size - 1 - nz[::-1].argmax(0)
    edges = [0, *starts, in_size]
    blocks = []
    for s, e in zip(edges[:-1], edges[1:]):
        lo, hi = np.maximum(first, s), np.minimum(last, e - 1)
        if (lo > hi).all():
            continue
        block = []
        for c in range(lanes):
            # the lane's first tap at or after lo, then every `lanes`-th
            k0 = lo + (c - (lo - s)) % lanes
            n = np.maximum((hi - k0) // lanes + 1, 0)
            t = np.arange(max(int(n.max()), 1))[:, None]
            k = k0[None] + lanes * t
            live = t < n[None]
            idx = np.where(live, k, 0)
            block.append((idx.astype(np.int64), np.where(live, wm[idx, np.arange(out_size)], 0.0).astype(np.float64)))
        blocks.append(tuple(block))
    return tuple(blocks)


@functools.lru_cache(maxsize=None)
def _device_taps(in_size: int, out_size: int, other: int, device: torch.device):
    """`_lane_taps` on `device`, uploaded once."""
    return tuple(
        tuple((torch.from_numpy(i).to(device), torch.from_numpy(w).to(device)) for i, w in block)
        for block in _lane_taps(in_size, out_size, other)
    )


def _chain(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One lane: fused multiply-adds emulated in float64 (the product is
    exact; one rounding to float32 a step)."""
    acc = None
    for t in range(idx.shape[0]):
        prod = x[:, idx[t]].double() * w[t]
        acc = prod.float() if acc is None else (prod + acc.double()).float()
    return acc


def _contract(x: torch.Tensor, in_size: int, out_size: int) -> torch.Tensor:
    """x [other, in] -> [other, out] in XLA's sums (`_XLA_SUMS`)."""
    out = None
    for block in _device_taps(in_size, out_size, x.shape[0], x.device):
        lanes = [_chain(x, idx, w) for idx, w in block]
        while len(lanes) > 1:
            lanes = [a + b for a, b in zip(lanes[::2], lanes[1::2])] + lanes[len(lanes) - len(lanes) % 2:]
        out = lanes[0] if out is None else out + lanes[0]
    return out


def resize_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H, W] float32 -> [h, w], as `jax.image.resize(img, (h, w),
    "linear")` (antialiased) sums it on XLA's CPU backend."""
    H, W = img.shape
    cols = lambda x: _contract(x, W, w)
    rows = lambda x: _contract(x.T, H, h).T
    # the einsum's contraction order: the cheaper first
    if h * H * W + h * W * w <= H * W * w + h * H * w:
        return cols(rows(img).contiguous())
    return rows(cols(img)).contiguous()


def build_pyramid(
    img: torch.Tensor, num_levels: int = 8, scale_factor: float = 1.2
) -> List[torch.Tensor]:
    """[H, W] float32 grayscale -> levels, each resized from level 0."""
    H, W = img.shape
    return [img] + [
        resize_linear(img, h, w)
        for h, w in pyramid_shapes(H, W, num_levels, scale_factor)[1:]
    ]


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] (0..255) -> [H, W] float32 grayscale."""
    rgb = rgb.to(torch.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]

