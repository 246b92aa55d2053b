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
einsum, rows first where that is cheaper, each a matrix product that
XLA's CPU backend sums as chains of fused multiply-adds along the
contracted axis. A level one float32 step off moves a blurred pixel
across a bf16 rounding boundary (BRIEF reads bf16) or breaks a FAST
score tie, so the port sums each output's few nonzero taps in the same
chains, emulating the fused multiply-add in float64 (the product is
exact), on every device alike. On the EVAL scene's VGA frames every
level equals the JAX package's op by op to the bit (two float32 matrix
products left 7-35% of each level an ulp off); other shapes take one
chain, unsplit. The blur adds its products as XLA's CPU convolution
does: in pairs, the pairs in turn.
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
    # the block sums added in turn (measured exact at 640, 480 and 320
    # rows; at 240 and 120 rows a few weights stay an ulp off)
    total = np.zeros((1, out_size), f32)
    for start in range(0, in_size, _SUM_BLOCK):
        total = total + np.add.reduce(w[start:start + _SUM_BLOCK], axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    ).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


# How XLA's CPU dot sums the resamplings of a VGA pyramid, measured
# against the JAX package op by op: (in, out) -> (chains, block starts).
# Each output's taps run in `chains` interleaved fused multiply-add
# chains (the even and the odd taps), restarted at each block start (the
# dot's split of the contracted axis) and the partial sums added in
# turn. Other shapes: one chain, no split.
_XLA_SUMS = {
    (480, 400): (1, (240,)), (480, 333): (1, (240,)), (480, 278): (1, (240,)),
    (640, 533): (2, ()), (640, 444): (1, (512,)), (640, 370): (1, (512,)),
}


@functools.lru_cache(maxsize=None)
def _band(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(idx [T, out] int64, w [T, out] float32): each output's taps, the
    run of inputs from its first to its last nonzero weight (zero weight
    past the run)."""
    wm = _weight_mat(in_size, out_size)
    nz = wm != 0
    first = nz.argmax(0)
    last = in_size - 1 - nz[::-1].argmax(0)
    t = np.arange(int((last - first).max()) + 1)[:, None]
    idx = np.minimum(first[None] + t, in_size - 1)
    w = np.where(first[None] + t <= last[None], np.take_along_axis(wm, idx, 0), np.float32(0.0))
    return idx.astype(np.int64), w.astype(np.float32)


def _contract(x: torch.Tensor, in_size: int, out_size: int) -> torch.Tensor:
    """x [..., in] -> [..., out] in XLA's sums (`_XLA_SUMS`): fused
    multiply-adds emulated in float64 (the product is exact; one rounding
    to float32 a step)."""
    chains, starts = _XLA_SUMS.get((in_size, out_size), (1, ()))
    idx_np, w_np = _band(in_size, out_size)
    # block of each tap: how many block starts lie at or below its input
    block_np = np.searchsorted(np.asarray(starts, np.int64), idx_np, side="right")
    idx, w, block = (torch.from_numpy(a).to(x.device) for a in (idx_np, w_np, block_np))
    out = None
    for b in range(len(starts) + 1):
        acc = [None] * chains
        for t in range(idx.shape[0]):
            wt = torch.where(block[t] == b, w[t], 0.0).double()
            prod = x[..., idx[t]].double() * wt
            c = t % chains
            acc[c] = prod.float() if acc[c] is None else (prod + acc[c].double()).float()
        part = acc[0]
        for a in acc[1:]:
            if a is not None:
                part = part + a
        out = part if out is None else out + part
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

