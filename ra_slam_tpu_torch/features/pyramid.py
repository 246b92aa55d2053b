"""Image pyramid + separable Gaussian blur (counterpart of
`ra_slam_tpu/features/pyramid.py`).

Each level is resized from level 0 with `jax.image.resize(method=
"linear")`'s own resampling: a triangle kernel widened by the scale
(antialiasing) and normalised per output sample. Its weight matrices are
built here in numpy the way `jax._src.image.scale.compute_weight_mat`
builds them, once per shape, and applied as two float32 matrix products.
(`F.interpolate(mode="bilinear", antialias=True)` resamples differently,
by up to 4e-3 of an intensity level at VGA: enough to flip FAST's
threshold tests.)
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _gauss_taps(sigma: float, radius: int) -> Tuple[float, ...]:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2).astype(np.float32)
    return tuple(float(v) for v in k / k.sum(dtype=np.float32))


def _conv_valid(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """'valid' correlation of x with the (symmetric) taps along `dim`,
    summed tap by tap in order."""
    n = x.shape[dim] - len(taps) + 1
    acc = None
    for j, k in enumerate(taps):
        term = x.narrow(dim, j, n) * k
        acc = term if acc is None else acc + term
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
    total = np.add.reduce(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    ).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H, W] float32 -> [h, w], as `jax.image.resize(img, (h, w),
    "linear")` (antialiased)."""
    H, W = img.shape
    wh = torch.from_numpy(_weight_mat(H, h)).to(img.device)  # [H, h]
    ww = torch.from_numpy(_weight_mat(W, w)).to(img.device)  # [W, w]
    return torch.matmul(wh.T, torch.matmul(img, ww))


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

