"""Flax's msgpack checkpoints (`flax.serialization.to_bytes` /
`msgpack_restore`) read and written without flax or msgpack.

A checkpoint is msgpack: nested maps with str keys whose array leaves
are ext type 1, each ext payload itself msgpack `(shape, dtype name, raw
C-order bytes)`; a params file starts `\\x81\\xa6params`. `unpackb`
decodes maps, arrays, str, bin, ints, floats, nil, bools and ext, with
ext type 1 as numpy arrays; `packb` encodes the same types in msgpack's
smallest forms, numpy arrays as ext type 1, so a tree of str-keyed dicts
with float32 leaves encodes to the bytes flax writes for it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1


class MsgpackError(ValueError):
    """Bytes that are not the msgpack this reader handles."""


def _read(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(data):
        raise MsgpackError(f"truncated msgpack: {n} bytes wanted at offset {pos}")
    return data[pos:pos + n], pos + n


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    if pos >= len(data):
        raise MsgpackError("truncated msgpack")
    b = data[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(data, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(data, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        raw, pos = _read(data, pos, b & 0x1F)
        return raw.decode("utf-8"), pos
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    sizes = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4, 0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4,
             0xC7: 1, 0xC8: 2, 0xC9: 4}
    if b in sizes:
        raw, pos = _read(data, pos, sizes[b])
        n = int.from_bytes(raw, "big")
        if b <= 0xC6:
            raw, pos = _read(data, pos, n)
            return raw, pos
        if b >= 0xD9 and b <= 0xDB:
            raw, pos = _read(data, pos, n)
            return raw.decode("utf-8"), pos
        if b in (0xDC, 0xDD):
            return _unpack_array(data, pos, n)
        if b in (0xDE, 0xDF):
            return _unpack_map(data, pos, n)
        return _unpack_ext(data, pos, n)
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        fmt = fixed[b]
        raw, pos = _read(data, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], pos
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        return _unpack_ext(data, pos, 1 << (b - 0xD4))
    raise MsgpackError(f"msgpack type byte 0x{b:02x} at offset {pos - 1} is not handled")


def _unpack_map(data, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        v, pos = _unpack(data, pos)
        out[k] = v
    return out, pos


def _unpack_array(data, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(data, pos)
        out.append(v)
    return out, pos


def _unpack_ext(data, pos, n):
    raw, pos = _read(data, pos, 1)
    code = struct.unpack(">b", raw)[0]
    payload, pos = _read(data, pos, n)
    if code != _EXT_NDARRAY:
        raise MsgpackError(f"msgpack ext type {code} is not handled (only ndarrays, type 1)")
    (shape, dtype, buf), end = _unpack(payload, 0)
    if end != len(payload):
        raise MsgpackError("ndarray ext payload has trailing bytes")
    if isinstance(dtype, bytes):
        dtype = dtype.decode("ascii")
    if dtype == "bfloat16":
        raise MsgpackError("bfloat16 leaves are not handled (numpy has no bfloat16)")
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy(), pos


def unpackb(data: bytes) -> Any:
    """The tree a msgpack document holds (`flax.serialization.
    msgpack_restore`'s result for a checkpoint)."""
    out, pos = _unpack(bytes(data), 0)
    if pos != len(data):
        raise MsgpackError(f"{len(data) - pos} trailing bytes after the msgpack document")
    return out


def _len_header(n: int, fix: int, fix_max: int, codes) -> bytes:
    if n <= fix_max and fix is not None:
        return bytes([fix | n])
    for code, width in codes:
        if n < (1 << (8 * width)):
            return bytes([code]) + n.to_bytes(width, "big")
    raise MsgpackError(f"length {n} too large for msgpack")


def _pack(x: Any, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, (bool, np.bool_)):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, (int, np.integer)) and not isinstance(x, np.ndarray):
        x = int(x)
        if 0 <= x <= 0x7F:
            out.append(bytes([x]))
        elif -32 <= x < 0:
            out.append(struct.pack(">b", x))
        elif x > 0:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
                if x < (1 << (8 * struct.calcsize(fmt))):
                    out.append(bytes([code]) + struct.pack(fmt, x))
                    break
        else:
            for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
                if x >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out.append(bytes([code]) + struct.pack(fmt, x))
                    break
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_len_header(len(raw), 0xA0, 31, ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + raw)
    elif isinstance(x, (bytes, bytearray)):
        out.append(_len_header(len(x), None, -1, ((0xC4, 1), (0xC5, 2), (0xC6, 4))) + bytes(x))
    elif isinstance(x, dict):
        out.append(_len_header(len(x), 0x80, 15, ((0xDE, 2), (0xDF, 4))))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        out.append(_len_header(len(x), 0x90, 15, ((0xDC, 2), (0xDD, 4))))
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        payload = packb((list(a.shape), a.dtype.name, a.tobytes("C")))
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        head = (bytes([fixext[n]]) if n in fixext
                else _len_header(n, None, -1, ((0xC7, 1), (0xC8, 2), (0xC9, 4))))
        out.append(head + struct.pack(">b", _EXT_NDARRAY) + payload)
    else:
        raise TypeError(f"cannot pack {type(x).__name__} as msgpack")


def packb(tree: Any) -> bytes:
    """msgpack bytes of a tree of dicts, lists, str, bytes, ints,
    floats, None, bools and numpy arrays (ext type 1, as flax writes)."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)
