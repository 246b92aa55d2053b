"""Write a ScanNet `.sens` file (version 4): JPEG colour through cv2
(libjpeg), zlib depth, camera-to-world poses.

The layout is ScanNet's `SensorData` (little-endian):

    u32 version | u64 name length, name | 4x4 f32 colour intrinsic,
    colour extrinsic, depth intrinsic, depth extrinsic | i32 colour
    compression (2 jpeg), i32 depth compression (1 zlib_ushort) | u32
    colour width, height, depth width, height | f32 depth shift | u64
    frames, then per frame 4x4 f32 camera-to-world, u64 colour and depth
    timestamps (microseconds), u64 colour and depth sizes, the two blobs
    | u64 IMU frames (0)

Frames are encoded in a thread pool (cv2 and zlib release the
interpreter lock) and written in order.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Sequence, Tuple

import numpy as np

COLOR_JPEG, DEPTH_ZLIB_USHORT = 2, 1
FRAME_HDR = struct.Struct("<16fQQQQ")


def encode_frame(rgb: np.ndarray, depth_raw: np.ndarray, quality: int, zlevel: int) -> Tuple[bytes, bytes]:
    import cv2

    ok, jpg = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]), [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return jpg.tobytes(), zlib.compress(np.ascontiguousarray(depth_raw, "<u2").tobytes(), zlevel)


def write_header(f, n_frames: int, color_k: np.ndarray, depth_k: np.ndarray, color_size, depth_size,
                 depth_shift: float, name: str = "benchmark") -> None:
    f.write(struct.pack("<I", 4))
    raw = name.encode("ascii")
    f.write(struct.pack("<Q", len(raw)) + raw)
    for mat in (color_k, np.eye(4), depth_k, np.eye(4)):
        f.write(np.asarray(mat, "<f4").tobytes())
    f.write(struct.pack("<ii", COLOR_JPEG, DEPTH_ZLIB_USHORT))
    f.write(struct.pack("<4I", *color_size, *depth_size))
    f.write(struct.pack("<f", float(depth_shift)))
    f.write(struct.pack("<Q", n_frames))


def k4(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    k = np.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = fx, fy, cx, cy
    return k


def write_sens(path: str, chunks: Iterable[Tuple[Sequence[np.ndarray], Sequence[np.ndarray]]],
               world_T_cam: np.ndarray, color_k: np.ndarray, depth_k: np.ndarray, color_size,
               depth_size, depth_shift: float, quality: int, zlevel: int, fps: float,
               threads: int = 8) -> int:
    """Write the frames that `chunks` yields, lists of (rgb [H, W, 3]
    uint8) and (raw depth [h, w] uint16) in frame order, with the poses
    `world_T_cam` [N, 4, 4]. Returns the bytes written."""
    n = len(world_T_cam)
    i = 0

    def put(f, futures):
        nonlocal i
        for fut in futures:
            color_blob, depth_blob = fut.result()
            ts = int(round(i * 1e6 / fps))
            f.write(FRAME_HDR.pack(*np.asarray(world_T_cam[i], np.float32).reshape(-1).tolist(),
                                   ts, ts, len(color_blob), len(depth_blob)))
            f.write(color_blob)
            f.write(depth_blob)
            i += 1

    with open(path, "wb") as f, ThreadPoolExecutor(threads) as pool:
        write_header(f, n, color_k, depth_k, color_size, depth_size, depth_shift)
        pending: list = []
        for rgbs, depths in chunks:  # the next chunk renders while this one encodes
            futures = [pool.submit(encode_frame, r, d, quality, zlevel) for r, d in zip(rgbs, depths)]
            put(f, pending)
            pending = futures
        put(f, pending)
        if i != n:
            raise ValueError(f"write_sens: {i} frames written, {n} poses given")
        f.write(struct.pack("<Q", 0))
        written = f.tell()
    return written
