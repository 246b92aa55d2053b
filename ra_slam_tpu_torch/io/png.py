"""A PNG reader and writer in numpy, zlib and struct (the JAX package
reads and writes its PNGs with cv2, which the port does not depend on).

The writer writes 8-bit grey, RGB or RGBA images and 16-bit grey
images, every row with filter type 0 (none) and one zlib stream.

The reader decodes non-interlaced 8-bit grey, RGB and RGBA and 16-bit
grey images, over any number of IDAT chunks, with all five row filters.
Rows filtered with none, Sub or Up are undone a row at a time (Sub as a
uint8 cumsum along the row). Average and Paeth make each byte depend on
its left, upper and upper-left neighbours, so an image holding such rows
is undone one anti-diagonal of pixels at a time, H + W - 1 vectorised
steps, every filter in one `np.select`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> channels


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 image [H, W] (grey), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA), or of a uint16 image [H, W] (16-bit grey)."""
    a = np.asarray(img)
    if a.dtype == np.uint16 and a.ndim == 2:
        depth, a = 16, a.astype(">u2")[..., None]
    elif a.dtype == np.uint8:
        depth = 8
        if a.ndim == 2:
            a = a[..., None]
    else:
        raise TypeError(f"PNG image must be uint8 or 2-D uint16, got {a.dtype} {np.shape(img)}")
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE or a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"PNG image must be [H, W] or [H, W, 3 | 4], got {np.shape(img)}")
    h, w, c = a.shape
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)
    raw = np.ascontiguousarray(a).view(np.uint8).reshape(h, -1)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 grey, RGB or RGBA image, or a uint16 grey image, as PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo filters 0 (none), 1 (Sub) and 2 (Up), a row at a time."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros(stride, np.uint8)
    for i in range(h):
        r = raw[i]
        if ftype[i] == 1:
            r = np.cumsum(r.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype[i] == 2:
            r = r + prev
        out[i] = prev = r
    return out


def _unfilter_wavefront(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo any mix of the five filters. Pixel (i, j) needs (i, j-1),
    (i-1, j) and (i-1, j-1), all on the two anti-diagonals before its
    own, so each anti-diagonal i + j = d is one vectorised step."""
    h, stride = raw.shape
    w = stride // bpp
    r = raw.reshape(h * w, bpp).astype(np.int16)
    # decoded pixels with a zero row above and a zero column to the left,
    # flat: padded (i + 1, j + 1) sits at i * w + w + 2 + (i + j), so one
    # anti-diagonal is a slice of step w, and its left, upper and
    # upper-left neighbours are the same slice shifted by 1, w + 1, w + 2
    x = np.zeros(((h + 1) * (w + 1), bpp), np.int16)
    f = ftype[:, None]
    conds = [f == 1, f == 2, f == 3, f == 4]
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d)
        s, n = lo * w + w + 2 + d, (hi - lo) * w + 1
        a, b, c = x[s - 1:s - 1 + n:w], x[s - w - 1:s - w - 1 + n:w], x[s - w - 2:s - w - 2 + n:w]
        rs = lo * (w - 1) + d  # raw (i, j) at i * w + j
        pred = np.select([m[lo:hi + 1] for m in conds], [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        x[s:s + n:w] = (r[rs:rs + (hi - lo) * (w - 1) + 1:w - 1] + pred) & 255
    return x.reshape(h + 1, w + 1, bpp)[1:, 1:].astype(np.uint8).reshape(h, stride)


def _decode(data: bytes) -> np.ndarray:
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"truncated PNG chunk {tag!r}")
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace != 0:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported (palette or grey+alpha)")
    if not (depth == 8 or (depth == 16 and ctype == 0)):
        raise ValueError(f"PNG bit depth {depth} with colour type {ctype} is not supported "
                         "(8-bit grey/RGB/RGBA and 16-bit grey are)")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    stride = w * bpp
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {flat.size} bytes, {h} rows of {stride + 1} expected")
    rows = flat.reshape(h, stride + 1)
    ftype, raw = rows[:, 0], rows[:, 1:]
    if (ftype > 4).any():
        raise ValueError(f"PNG row filter {int(ftype.max())} is not one of 0-4")
    if (ftype >= 3).any():
        pix = _unfilter_wavefront(raw, ftype, bpp)
    else:
        pix = _unfilter_rows(raw, ftype, bpp)
    if depth == 16:
        return pix.view(">u2").astype(np.uint16).reshape(h, w)
    return pix.reshape(h, w) if c == 1 else pix.reshape(h, w, c)


def decode_png(data: bytes, mode: str = "unchanged") -> np.ndarray:
    """Pixels of a PNG, as cv2.imdecode's flags give them but in RGB
    order: `unchanged` (IMREAD_UNCHANGED: [H, W] uint8 grey or uint16
    16-bit grey, [H, W, 3] RGB, [H, W, 4] RGBA), `color` (IMREAD_COLOR:
    [H, W, 3] uint8; grey replicated, alpha dropped) or `grayscale`
    (IMREAD_GRAYSCALE: [H, W] uint8, from 8-bit grey files only). Raises
    ValueError on bytes that are not a PNG and on an interlaced,
    palette, grey+alpha or other-bit-depth image."""
    if mode not in ("unchanged", "color", "grayscale"):
        raise ValueError(f"unknown PNG read mode {mode!r}")
    img = _decode(data)
    if mode == "unchanged":
        return img
    if img.dtype != np.uint8:
        raise ValueError(f"16-bit PNG read as {mode}; read it unchanged")
    if mode == "color":
        return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img[..., :3].copy()
    if img.ndim != 2:
        raise ValueError("colour PNG read as grayscale is not supported")
    return img


def read_png(path: str, mode: str = "unchanged") -> np.ndarray:
    """`decode_png` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_png(f.read(), mode)
