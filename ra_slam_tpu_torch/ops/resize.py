"""cv2.resize as torch functions, on the card or the CPU (the JAX package
resizes with cv2: `pipeline/system.py`'s resize branch, `io/sens.py`'s
colour-to-depth resize, `models/segmentation.py`'s resize back).

The source indices and weights are computed on the host in the
precision cv2 uses; the gathers and sums run on the tensor's device in
integer arithmetic (uint8) or separate float32 operations, so the card
and the CPU agree exactly.

- `INTER_NEAREST` takes source index floor(dst * (1 / (dst_size /
  src_size))), in double, clamped to the last pixel (not the pixel
  centre: that is `INTER_NEAREST_EXACT`). Exact against cv2.
- `INTER_LINEAR` samples at half-pixel centres, (dst + 0.5) * scale -
  0.5, with the border pixels clamped. For uint8, cv2 takes the
  coordinate in float32, 11-bit fixed-point weights each way, and
  rounds once at the end: emulated exactly. For float32, cv2's own sums
  are not reproduced bit for bit: with the coordinate in double and
  float32 weights the result lies within 3 float32 ulps of the largest
  input magnitude of cv2's (`tests/test_torch_resize.py`).

Where each resize runs is where its tensor is: the `.sens` reader's
JPEG colour on the card that nvjpeg decoded it onto, PNG and raw colour
on the host, the facade's and segmentation's resizes on their frames'
device. The uint8 tables are built and uploaded once per source size,
output size and device (`_u8_tables`), not on every call.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE (11 bits)

_TABLES: dict = {}  # (h, w, height, width, device) -> the uint8 tables on that device
_TABLES_LOCK = threading.Lock()  # SensReader.prefetch resizes from threads


def _nearest_index(src: int, dst: int) -> np.ndarray:
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def _linear_axis(src: int, dst: int, coord_f32: bool, clamp_weight: bool):
    """(i0, i1, frac) of one axis. cv2 zeroes the fraction at the x
    borders (`clamp_weight`) but only clamps the row indices in y."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    if coord_f32:
        f = f.astype(np.float32)
    i = np.floor(f).astype(np.int64)
    frac = (f - i.astype(f.dtype)).astype(np.float32)
    if clamp_weight:
        edge = (i < 0) | (i >= src - 1)
        frac[edge] = 0.0
        i = np.clip(i, 0, src - 1)
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), frac


def _check(img: torch.Tensor, width: int, height: int) -> None:
    if img.ndim not in (2, 3) or img.shape[0] == 0 or img.shape[1] == 0:
        raise ValueError(f"resize takes [H, W] or [H, W, C], got {tuple(img.shape)}")
    if width <= 0 or height <= 0:
        raise ValueError(f"resize to {width}x{height}")


def resize_nearest(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """`cv2.resize(img, (width, height), interpolation=INTER_NEAREST)`,
    any dtype, [H, W] or [H, W, C]."""
    _check(img, width, height)
    h, w = img.shape[:2]
    iy = torch.as_tensor(_nearest_index(h, height), device=img.device)
    ix = torch.as_tensor(_nearest_index(w, width), device=img.device)
    return img.index_select(0, iy).index_select(1, ix)


def _u8_axis(src: int, dst: int, clamp_weight: bool):
    """(i0, i1, w0, w1) of one axis in cv2's uint8 fixed point: the
    coordinate in float32, 11-bit weights rounded to nearest even."""
    i0, i1, frac = _linear_axis(src, dst, coord_f32=True, clamp_weight=clamp_weight)
    w1 = np.rint(frac * np.float32(_COEF_SCALE))
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE))
    return i0, i1, w0, w1


def _u8_tables(h: int, w: int, height: int, width: int, device: torch.device):
    """cv2's uint8 INTER_LINEAR tables from [h, w] to [height, width] on
    `device`, int32 (x0, x1, a0, a1, y0, y1, b0, b1), built and uploaded
    once per sizes and device."""
    key = (h, w, height, width, device)
    with _TABLES_LOCK:
        tabs = _TABLES.get(key)
        if tabs is None:
            axes = (*_u8_axis(w, width, True), *_u8_axis(h, height, False))
            tabs = _TABLES[key] = tuple(torch.as_tensor(a.astype(np.int32), device=device) for a in axes)
    return tabs


def resize_linear(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """`cv2.resize(img, (width, height))` (INTER_LINEAR) of a uint8 or
    float32 image, [H, W] or [H, W, C], in torch operations on the
    image's device."""
    _check(img, width, height)
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"linear resize takes uint8 or float32, got {img.dtype}")
    h, w = img.shape[:2]
    bshape = (1, width) + (1,) * (img.ndim - 2)  # weights broadcast over rows (x) or columns (y)
    cshape = (height, 1) + (1,) * (img.ndim - 2)
    if img.dtype == torch.uint8:
        x0, x1, a0, a1, y0, y1, b0, b1 = _u8_tables(h, w, height, width, img.device)
        s = img.to(torch.int32)
        hz = s.index_select(1, x0) * a0.view(bshape) + s.index_select(1, x1) * a1.view(bshape)
        top = (b0.view(cshape) * (hz.index_select(0, y0) >> 4)) >> 16
        bot = (b1.view(cshape) * (hz.index_select(0, y1) >> 4)) >> 16
        return ((top + bot + 2) >> 2).to(torch.uint8)
    x0, x1, fx = _linear_axis(w, width, coord_f32=False, clamp_weight=True)
    y0, y1, fy = _linear_axis(h, height, coord_f32=False, clamp_weight=False)
    t = lambda a: torch.as_tensor(a, device=img.device)
    a1, b1 = t(fx).view(bshape), t(fy).view(cshape)
    hz = img.index_select(1, t(x0)) * (1.0 - a1) + img.index_select(1, t(x1)) * a1
    return hz.index_select(0, t(y0)) * (1.0 - b1) + hz.index_select(0, t(y1)) * b1


def resize(img: torch.Tensor, width: int, height: int, interpolation: str = "linear") -> torch.Tensor:
    """`cv2.resize` with `interpolation` "linear" (INTER_LINEAR, cv2's
    default) or "nearest" (INTER_NEAREST)."""
    if interpolation == "linear":
        return resize_linear(img, width, height)
    if interpolation == "nearest":
        return resize_nearest(img, width, height)
    raise ValueError(f"unknown interpolation {interpolation!r}")
