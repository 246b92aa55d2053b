"""A plain `.sens` reader: struct, zlib, and cv2 (libjpeg) for JPEG colour.

It reads what ScanNet's `SensorData` writes and returns each frame as the
reference's pipeline takes it: depth in metres (raw / depth shift, in
float32) at the depth size, colour decoded by libjpeg and resized to the
depth size by `cv2.resize(..., INTER_LINEAR)`, and the pose as
cam_T_world, the inverse of the stored camera-to-world in float64,
rounded to float32.

`control=True` reads at the precision below the one the configuration
states, for the control run: depth and pose rounded to bfloat16, colour
to 7 bits.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np
import torch

_FRAME_HDR = struct.Struct("<16fQQQQ")


class Sens:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        d, pos = self.data, 0
        (self.version,), pos = struct.unpack_from("<I", d, pos), pos + 4
        (n,), pos = struct.unpack_from("<Q", d, pos), pos + 8
        pos += n
        mats = np.frombuffer(d, "<f4", 64, pos).reshape(4, 4, 4)
        pos += 256
        self.depth_k = mats[2].astype(np.float64)
        self.color_comp, self.depth_comp = struct.unpack_from("<ii", d, pos)
        pos += 8
        self.color_w, self.color_h, self.depth_w, self.depth_h = struct.unpack_from("<4I", d, pos)
        pos += 16
        (self.depth_shift,) = struct.unpack_from("<f", d, pos)
        pos += 4
        (frames,) = struct.unpack_from("<Q", d, pos)
        pos += 8
        self.frames: List[Tuple[np.ndarray, int, int, int, int]] = []
        for _ in range(frames):
            hdr = _FRAME_HDR.unpack_from(d, pos)
            pos += _FRAME_HDR.size
            c2w = np.array(hdr[:16], np.float32).reshape(4, 4)
            cb, db = hdr[18], hdr[19]
            self.frames.append((c2w, pos, cb, pos + cb, db))
            pos += cb + db
        if self.color_comp != 2 or self.depth_comp != 1:
            raise ValueError("reference reader: JPEG colour and zlib depth only")

    def __len__(self) -> int:
        return len(self.frames)

    def depth(self, i: int, control: bool = False) -> np.ndarray:
        _, _, _, ofs, n = self.frames[i]
        raw = np.frombuffer(zlib.decompress(self.data[ofs:ofs + n]), "<u2").reshape(self.depth_h, self.depth_w)
        d = raw.astype(np.float32) / np.float32(self.depth_shift)
        return _bf16(d) if control else d

    def pose(self, i: int, control: bool = False) -> np.ndarray:
        p = np.linalg.inv(self.frames[i][0].astype(np.float64)).astype(np.float32)
        return _bf16(p) if control else p

    def color(self, i: int, control: bool = False) -> np.ndarray:
        import cv2

        _, ofs, n, _, _ = self.frames[i]
        bgr = cv2.imdecode(np.frombuffer(self.data, np.uint8, n, ofs), cv2.IMREAD_COLOR)
        rgb = cv2.resize(bgr[..., ::-1], (self.depth_w, self.depth_h), interpolation=cv2.INTER_LINEAR)
        if control:
            rgb = np.minimum((rgb.astype(np.int32) + 1) // 2 * 2, 254).astype(np.uint8)
        return np.ascontiguousarray(rgb)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()
