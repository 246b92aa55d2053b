"""The PyTorch port's PNG reader and writer (ra_slam_tpu_torch/io/png.py)
against cv2, which the JAX package reads and writes its PNGs with: the
decoder equals cv2.imread on files cv2 wrote, with cv2's default row
filter (Sub) and with every filter type (0-4) mixed in one image; the
16-bit writer's files read back through cv2."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from ra_slam_tpu_torch.io.png import decode_png, encode_png, read_png, write_png

ALL_FILTERS = [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]


def _mixed(h=96, w=128, seed=0):
    """An RGB image of flat areas, gradients and noise: libpng's adaptive
    choice then uses every filter type."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx * 3 + yy * 5) % 256], -1).astype(np.uint8)
    img[: h // 8] = 0  # flat rows: filter 0
    img[h // 4: h // 2, w // 4: 3 * w // 4] = rng.integers(0, 256, (h // 4, w // 2, 3))
    img[5 * h // 8: 3 * h // 4] = 200
    img[3 * h // 4:, :: 2] = rng.integers(0, 256, (h - 3 * h // 4, (w + 1) // 2, 3))
    return img


def _filter_types(data: bytes) -> set:
    """The row filter bytes of a PNG (read without the decoder under test)."""
    pos, idat = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    stride = w * {0: 1, 2: 3, 6: 4}[ctype] * depth // 8 + 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride)
    return set(raw[:, 0].tolist())


def _variants():
    rgb = _mixed()
    rng = np.random.default_rng(1)
    u16 = (rgb[..., 0].astype(np.uint16) * 257 + rng.integers(0, 40, rgb.shape[:2])).astype(np.uint16)
    u16[: len(u16) // 8] = 0
    return {
        "rgb": rgb,
        "grey": rgb[..., 1].copy(),
        "depth16": u16,
        "rgba": np.concatenate([rgb, rgb[..., :1]], axis=-1),
    }


def _to_cv2(img):
    if img.ndim == 3:
        return cv2.cvtColor(img, cv2.COLOR_RGB2BGR if img.shape[2] == 3 else cv2.COLOR_RGBA2BGRA)
    return img


def _from_cv2(img):
    if img.ndim == 3:
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB if img.shape[2] == 3 else cv2.COLOR_BGRA2RGBA)
    return img


@pytest.mark.parametrize("flags", [[], ALL_FILTERS], ids=["cv2-default", "all-filters"])
@pytest.mark.parametrize("kind", ["rgb", "grey", "depth16", "rgba"])
def test_decode_matches_cv2_imread(tmp_path, kind, flags):
    img = _variants()[kind]
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, _to_cv2(img), flags)
    with open(path, "rb") as f:
        seen = _filter_types(f.read())
    if flags:
        assert seen == {0, 1, 2, 3, 4}, seen
    else:
        assert seen == {1}, seen  # cv2 5's default: Sub on every row
    got = read_png(path)
    want = _from_cv2(cv2.imread(path, cv2.IMREAD_UNCHANGED))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if kind != "depth16":
        np.testing.assert_array_equal(read_png(path, "color"), _from_cv2(cv2.imread(path, cv2.IMREAD_COLOR)))
    if kind == "grey":
        np.testing.assert_array_equal(read_png(path, "grayscale"), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_decode_multiple_idat_chunks():
    """A stream split over several IDAT chunks (as libpng does past 8 KB)."""
    img = _mixed(64, 80)
    data = encode_png(img)
    sig, rest = data[:8], data[8:]
    ihdr, rest = rest[:25], rest[25:]
    (n,) = struct.unpack(">I", rest[:4])
    stream, iend = rest[8:8 + n], rest[12 + n:]
    chunks = b"".join(
        struct.pack(">I", len(part)) + b"IDAT" + part + struct.pack(">I", zlib.crc32(b"IDAT" + part))
        for part in (stream[i:i + 1000] for i in range(0, len(stream), 1000)))
    np.testing.assert_array_equal(decode_png(sig + ihdr + chunks + iend), img)


@pytest.mark.parametrize("kind", ["rgb", "grey", "depth16", "rgba"])
def test_writer_read_by_cv2(tmp_path, kind):
    img = _variants()[kind]
    path = str(tmp_path / f"{kind}.png")
    write_png(path, img)
    np.testing.assert_array_equal(_from_cv2(cv2.imread(path, cv2.IMREAD_UNCHANGED)), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_decode_rejects_unsupported(tmp_path):
    grey = np.arange(48, dtype=np.uint8).reshape(6, 8)
    ok, enc = cv2.imencode(".png", np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16 with colour type 2"):
        decode_png(enc.tobytes())
    data = bytearray(encode_png(grey))
    data[8 + 8 + 12] = 1  # IHDR interlace byte (CRC is not checked)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(bytes(data))
    data = bytearray(encode_png(grey))
    data[8 + 8 + 9] = 3  # colour type 3: palette
    with pytest.raises(ValueError, match="palette"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="read it unchanged"):
        decode_png(encode_png(grey.astype(np.uint16)), "color")
    with pytest.raises(TypeError):
        encode_png(np.zeros((4, 4, 3), np.uint16))
