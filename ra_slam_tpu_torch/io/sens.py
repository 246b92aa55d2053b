"""ScanNet `.sens` sequence reader and writer (counterpart of
`ra_slam_tpu/io/sens.py`).

File layout (little-endian, version 4):

    u32  version
    u64  sensor-name length, then that many bytes
    4x4 f32 color intrinsic | 4x4 f32 color extrinsic
    4x4 f32 depth intrinsic | 4x4 f32 depth extrinsic
    i32  color compression (0 raw, 1 png, 2 jpeg)
    i32  depth compression (0 raw_ushort, 1 zlib_ushort, 2 occi_ushort)
    u32  colorWidth, colorHeight, depthWidth, depthHeight
    f32  depthShift (raw units per meter)
    u64  numFrames, then per frame:
        4x4 f32 camera-to-world, u64 tsColor, u64 tsDepth,
        u64 colorBytes, u64 depthBytes, color blob, depth blob
    u64  numIMUFrames, then 5*vec3d + u64 each (skipped)

The intrinsics come from the depth calibration, the depth extrinsics
must be identity, colour is resized to the output size (INTER_LINEAR)
and depth too where a target size is asked for (INTER_NEAREST, the
intrinsics rescaled), and the stored camera-to-world pose is inverted in
float64 to cam_T_world. PNG colour decodes through `io/png.py`, JPEG
colour through `io/jpeg.py` (nvjpeg on a CUDA device; without one a
JPEG `.sens` raises), the resizes through `ops/resize.py`. Where the
colour is resized: JPEG colour stays on the card that nvjpeg decoded it
onto, is resized there, and only the output-size image is copied to the
host (`sens.to_host`); PNG and raw colour are resized on the host, each
such frame counted in `HOST_RESIZES` (`sens.host_resizes`). Depth is
inflated and resized on the host. `Frame.rgb` is a host array either
way, owned by its frame.
`write_sens` encodes PNG colour through `io/png.py` and JPEG colour
through nvjpeg on a CUDA device.

Blobs are read with `os.pread`, which moves no shared file position, so
`prefetch(num_threads, capacity)` can decode frames ahead in Python
threads and yield them in order (`offline_eval --native-io`, the JAX
package's C++ prefetcher): zlib, the PNG decoder's numpy work and nvjpeg
release the interpreter lock for most of their time.
"""

from __future__ import annotations

import collections
import functools
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.io.dataset import Frame, RGBDDataset
from ra_slam_tpu_torch.io.png import decode_png, encode_png
from ra_slam_tpu_torch.ops.resize import resize_linear, resize_nearest
from ra_slam_tpu_torch.utils.profiling import TRACE

COLOR_RAW, COLOR_PNG, COLOR_JPEG = 0, 1, 2
DEPTH_RAW_USHORT, DEPTH_ZLIB_USHORT, DEPTH_OCCI_USHORT = 0, 1, 2

HOST_RESIZES = 0  # frames whose colour `frame()` resized on the host
TRACE.expose("sens.host_resizes", lambda: HOST_RESIZES)
_COUNT_LOCK = threading.Lock()  # `prefetch` reads frames from threads

_MAT4 = struct.Struct("<16f")
_FRAME_HDR = struct.Struct("<16fQQQQ")


def _read_exact(f: BinaryIO, n: int) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise EOFError(f"truncated .sens file: wanted {n} bytes, got {len(buf)}")
    return buf


def _read_mat4(f: BinaryIO) -> np.ndarray:
    return np.array(_MAT4.unpack(_read_exact(f, 64)), np.float32).reshape(4, 4)


class SensReader(RGBDDataset):
    """Random-access reader over a `.sens` file: frame headers and blob
    offsets are indexed once at open, each frame decoded in `frame()`."""

    def __init__(self, path: str, target_size: Optional[Tuple[int, int]] = None):
        self.path = path
        self._f = open(path, "rb")
        f = self._f

        (self.version,) = struct.unpack("<I", _read_exact(f, 4))
        (name_len,) = struct.unpack("<Q", _read_exact(f, 8))
        self.sensor_name = _read_exact(f, name_len).decode("ascii", "replace")
        self.color_intrinsic = _read_mat4(f)
        self.color_extrinsic = _read_mat4(f)
        self.depth_intrinsic = _read_mat4(f)
        self.depth_extrinsic = _read_mat4(f)
        if not np.allclose(self.depth_extrinsic, np.eye(4)):
            self._f.close()
            raise ValueError("ScanNet depth extrinsics must be identity")
        self.color_compression, self.depth_compression = struct.unpack("<ii", _read_exact(f, 8))
        self.color_width, self.color_height, self.depth_width, self.depth_height = struct.unpack(
            "<4I", _read_exact(f, 16))
        (self.depth_shift,) = struct.unpack("<f", _read_exact(f, 4))

        (num_frames,) = struct.unpack("<Q", _read_exact(f, 8))
        self._poses: List[np.ndarray] = []
        self._ts: List[float] = []
        self._blob_ofs: List[Tuple[int, int, int, int]] = []
        for _ in range(num_frames):
            hdr = _FRAME_HDR.unpack(_read_exact(f, _FRAME_HDR.size))
            ts_color, _ts_depth, color_bytes, depth_bytes = hdr[16:]
            ofs = f.tell()
            f.seek(color_bytes + depth_bytes, 1)
            self._poses.append(np.array(hdr[:16], np.float32).reshape(4, 4))
            self._ts.append(ts_color * 1e-6)  # microseconds -> seconds
            self._blob_ofs.append((ofs, color_bytes, ofs + color_bytes, depth_bytes))
        self._out_w, self._out_h = target_size or (int(self.depth_width), int(self.depth_height))
        # JPEG colour is decoded onto, and resized on, the CUDA device where there is one
        self._color_on_device = self.color_compression == COLOR_JPEG and torch.cuda.is_available()

    def __len__(self) -> int:
        return len(self._poses)

    @property
    def camera(self) -> PinholeCamera:
        """Depth-camera intrinsics, rescaled to a non-native target size."""
        k = self.depth_intrinsic
        sx = self._out_w / float(self.depth_width)
        sy = self._out_h / float(self.depth_height)
        return PinholeCamera.create(
            float(k[0, 0]) * sx, float(k[1, 1]) * sy, float(k[0, 2]) * sx, float(k[1, 2]) * sy,
            self._out_w, self._out_h,
        )

    @property
    def depth_factor(self) -> float:
        return float(self.depth_shift)

    def pose(self, idx: int) -> np.ndarray:
        """cam_T_world = inverse(stored camera-to-world), in float64."""
        return np.linalg.inv(self._poses[idx].astype(np.float64)).astype(np.float32)

    def _blob(self, ofs: int, nbytes: int) -> bytes:
        buf = os.pread(self._f.fileno(), nbytes, ofs)  # no shared file position: threads may share the file
        if len(buf) != nbytes:
            raise EOFError(f"truncated .sens file: wanted {nbytes} bytes, got {len(buf)}")
        return buf

    def _raw_color(self, idx: int):
        """The stored colour, [H, W, 3] uint8: nvjpeg's decode on the CUDA
        device for JPEG where there is one, else a host array (JPEG then
        goes through `decode_jpeg_numpy`, which raises without a device)."""
        ofs, nbytes, _, _ = self._blob_ofs[idx]
        blob = self._blob(ofs, nbytes)
        if self.color_compression == COLOR_PNG:
            return decode_png(blob, "color")
        if self.color_compression == COLOR_JPEG:
            from ra_slam_tpu_torch.io import jpeg

            return jpeg.decode_jpeg(blob) if self._color_on_device else jpeg.decode_jpeg_numpy(blob)
        if self.color_compression != COLOR_RAW:
            raise NotImplementedError(f"colour compression {self.color_compression} not supported")
        return np.frombuffer(blob, np.uint8).reshape(self.color_height, self.color_width, 3)

    def _raw_depth(self, idx: int) -> np.ndarray:
        _, _, ofs, nbytes = self._blob_ofs[idx]
        blob = self._blob(ofs, nbytes)
        if self.depth_compression == DEPTH_ZLIB_USHORT:
            blob = zlib.decompress(blob)
        elif self.depth_compression != DEPTH_RAW_USHORT:
            raise NotImplementedError(f"depth compression {self.depth_compression} not supported")
        return np.frombuffer(blob, "<u2").reshape(self.depth_height, self.depth_width)

    def frame(self, idx: int) -> Frame:
        global HOST_RESIZES
        with TRACE.span("sens.frame"):
            with TRACE.span("sens.color"):
                rgb = self._raw_color(idx)
            if rgb.shape[:2] != (self._out_h, self._out_w):
                with TRACE.span("sens.resize"):
                    if isinstance(rgb, np.ndarray):
                        rgb = torch.from_numpy(np.ascontiguousarray(rgb))
                        with _COUNT_LOCK:
                            HOST_RESIZES += 1
                    rgb = resize_linear(rgb, self._out_w, self._out_h)
            if isinstance(rgb, torch.Tensor) and rgb.is_cuda:
                with TRACE.wait("sens.to_host"):
                    rgb = rgb.cpu()
            with TRACE.span("sens.depth"):
                depth_raw = self._raw_depth(idx)
                if depth_raw.shape != (self._out_h, self._out_w):
                    d = torch.from_numpy(depth_raw.astype(np.int32))
                    depth_raw = resize_nearest(d, self._out_w, self._out_h).numpy().astype(np.uint16)
                depth = depth_raw.astype(np.float32) / self.depth_shift
            return Frame(frame_id=idx, timestamp=self._ts[idx], rgb=np.asarray(rgb), depth=depth, cam_T_world=self.pose(idx))

    def prefetch(self, num_threads: int = 2, capacity: int = 8) -> Iterator[Frame]:
        """Iterate the frames in order, decoded ahead by `num_threads`
        threads, at most `capacity` frames in flight."""
        if num_threads < 1 or capacity < 1:
            raise ValueError(f"prefetch needs num_threads >= 1 and capacity >= 1, got {num_threads}, {capacity}")
        pending: collections.deque = collections.deque()
        with ThreadPoolExecutor(num_threads, thread_name_prefix="sens_prefetch") as pool:
            try:
                for idx in range(len(self)):
                    pending.append(pool.submit(self.frame, idx))
                    if len(pending) >= capacity:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for fut in pending:
                    fut.cancel()

    def close(self) -> None:
        self._f.close()


def write_sens(
    path: str,
    rgbs: Sequence[np.ndarray],  # [H, W, 3] uint8 each
    depths_raw: Sequence[np.ndarray],  # [H, W] uint16 each
    camera_to_world: Sequence[np.ndarray],  # [4, 4] float32 each
    intrinsic: np.ndarray,  # [4, 4] (or [3, 3]) float32
    depth_shift: float = 1000.0,
    sensor_name: str = "ra_slam_tpu",
    timestamps_us: Optional[Sequence[int]] = None,
    color_compression: int = COLOR_PNG,
    device="cuda",
) -> None:
    """Write a version-4 `.sens` file with zlib depth and PNG colour, or
    JPEG colour (quality 95, 4:2:0, as the JAX writer's cv2) encoded by
    nvjpeg on `device`. PNG is the default here (the JAX writer's is
    JPEG): the CPU has no JPEG encoder, and JPEG on a CPU device raises."""
    if color_compression not in (COLOR_PNG, COLOR_JPEG):
        raise ValueError("color_compression must be COLOR_PNG or COLOR_JPEG")
    if color_compression == COLOR_JPEG:
        from ra_slam_tpu_torch.io.jpeg import encode_jpeg, encoder_device

        encode = functools.partial(encode_jpeg, quality=95, device=encoder_device(device))
    else:
        encode = encode_png
    k4 = np.eye(4, dtype=np.float32)
    intrinsic = np.asarray(intrinsic, np.float32)
    k4[: intrinsic.shape[0], : intrinsic.shape[1]] = intrinsic
    h, w = depths_raw[0].shape
    ch, cw = rgbs[0].shape[:2]

    with open(path, "wb") as f:
        f.write(struct.pack("<I", 4))
        name = sensor_name.encode("ascii")
        f.write(struct.pack("<Q", len(name)) + name)
        for mat in (k4, np.eye(4, dtype=np.float32), k4, np.eye(4, dtype=np.float32)):
            f.write(mat.astype("<f4").tobytes())
        f.write(struct.pack("<ii", color_compression, DEPTH_ZLIB_USHORT))
        f.write(struct.pack("<4I", cw, ch, w, h))
        f.write(struct.pack("<f", float(depth_shift)))
        f.write(struct.pack("<Q", len(rgbs)))
        for i, (rgb, d, c2w) in enumerate(zip(rgbs, depths_raw, camera_to_world)):
            color_blob = encode(np.asarray(rgb, np.uint8))
            depth_blob = zlib.compress(np.ascontiguousarray(d, "<u2").tobytes(), 6)
            ts = int(timestamps_us[i]) if timestamps_us is not None else i * 33333
            f.write(_FRAME_HDR.pack(*np.asarray(c2w, np.float32).reshape(-1).tolist(),
                                    ts, ts, len(color_blob), len(depth_blob)))
            f.write(color_blob)
            f.write(depth_blob)
        f.write(struct.pack("<Q", 0))  # no IMU frames
