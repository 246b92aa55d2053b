"""A PNG writer in numpy, zlib and struct (the JAX package writes its
renders with cv2, which the port does not depend on).

Writes 8-bit grey, RGB or RGBA images, every row with filter type 0
(none) and one zlib stream.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 image [H, W] (grey), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"PNG image must be uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE or a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"PNG image must be [H, W] or [H, W, 3 | 4], got {np.shape(img)}")
    h, w, c = a.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 grey, RGB or RGBA image as PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
