"""The app layer of the PyTorch port on the CPU: profiling spans
(utils/profiling.py), the async and frame loggers (utils/data_logger.py,
PNGs through io/png.py) against the JAX package's (cv2), the ZED
calibration tooling (io/capture.py) against the JAX package's text, the
camera drivers' refusals (io/cameras.py), and the threaded `.sens`
prefetcher (`SensReader.prefetch`, io/sens.py) and byte queue
(io/prefetch.py) with tests/test_native.py's semantics."""

import os
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads)
from ra_slam_tpu.io import capture as jcapture
from ra_slam_tpu.utils.data_logger import FrameLogger as JaxFrameLogger
from ra_slam_tpu_torch.io import cameras, capture
from ra_slam_tpu_torch.io.folder import FolderReader
from ra_slam_tpu_torch.io.prefetch import ByteQueue
from ra_slam_tpu_torch.io.sens import SensReader, write_sens
from ra_slam_tpu_torch.utils import profiling
from ra_slam_tpu_torch.utils.data_logger import AsyncLogger, FrameLogger
from test_capture import _CONF


def test_stage_timer_accumulates(tmp_path):
    """The program's span registry (`profiling.TRACE`, a StageTimer):
    off, a span adds nothing; on, spans add to the per-name totals of
    `summary` and `report`, and inside `device_trace` each is a named
    `ra.` range of the written trace."""
    t = profiling.TRACE
    assert isinstance(t, profiling.StageTimer) and not t.enabled
    x = torch.ones(4)
    with t.span("app.work"):
        time.sleep(0.01)
    assert "app.work" not in t.summary()
    t.enable()
    try:
        for _ in range(3):
            with t.span("app.work", block_on={"x": [x]}):
                time.sleep(0.01)
        s = t.summary()["app.work"]
        assert s["count"] == 3 and s["mean_ms"] >= 9.0 and t.mean_ms("app.work") >= 9.0
        assert "app.work" in t.report()
        with profiling.device_trace(str(tmp_path / "trace")):
            with t.span("app.scoped"):
                (x * 2).sum()
    finally:
        t.enable(False)
        t.drain()
    assert '"ra.app.scoped"' in (tmp_path / "trace" / "trace.json").read_text()
    with profiling.device_trace(None):
        pass


def test_async_logger_writes_and_drops():
    written = []

    def slow_write(x):
        time.sleep(0.02)
        written.append(x)

    lg = AsyncLogger(slow_write, capacity=2)
    results = [lg.log(i) for i in range(10)]
    lg.close()
    accepted = [i for i, ok in zip(range(10), results) if ok]
    assert written == accepted  # everything accepted was written, in order
    assert lg.dropped == 10 - len(accepted) > 0
    assert not lg.log(11)  # closed


def test_frame_logger_files_decode_to_jax(tmp_path):
    """The same frames logged by both packages: every PNG decodes (cv2)
    to the same pixels, the trajectory files are equal, and the port's
    FolderReader reads the folder back."""
    h, w = 24, 32
    rng = np.random.default_rng(0)
    frames = [(i, rng.integers(0, 256, (h, w, 3), dtype=np.uint8), rng.uniform(0.3, 5.0, (h, w)).astype(np.float32),
               rng.random((h, w)), rng.random((h, w)) if i else None) for i in range(3)]
    poses = [(i, np.eye(4, dtype=np.float32) + 0.1 * i) for i in range(4)]
    for name, cls in (("jax", JaxFrameLogger), ("port", FrameLogger)):
        lg = cls(str(tmp_path / name), depth_factor=1000.0, capacity=8)
        for fid, rgb, depth, ht, lt in frames:
            assert lg.log_frame(fid, rgb, depth, ht=ht, lt=lt)
        lg.close()
        lg.save_trajectory(poses)
        assert lg.dropped == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and "2_no_ht.png" in names and "0_no_ht.png" not in names
    for n in names:
        if n.endswith(".png"):
            a = cv2.imread(str(tmp_path / "jax" / n), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(tmp_path / "port" / n), cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype, n
            np.testing.assert_array_equal(a, b, err_msg=n)
    assert (tmp_path / "jax" / "trajectory.txt").read_text() == (tmp_path / "port" / "trajectory.txt").read_text()
    (tmp_path / "port" / "camera_config.yaml").write_text(
        "Camera.fx: 30.0\nCamera.fy: 30.0\nCamera.cx: 15.5\nCamera.cy: 11.5\ndepthmap_factor: 1000.0\n")
    fr = FolderReader(str(tmp_path / "port")).frame(1)
    np.testing.assert_array_equal(fr.rgb, frames[1][1])
    np.testing.assert_allclose(fr.depth, frames[1][2], atol=1e-3)


def test_zed_conf_and_yaml_text_match_jax(tmp_path):
    p = tmp_path / "SN000.conf"
    p.write_text(_CONF)
    for res in ("720p",):
        ours, theirs = capture.parse_zed_conf(str(p), res), jcapture.parse_zed_conf(str(p), res)
        assert ours == theirs
        w, h = capture.RESOLUTIONS[res]
        assert capture.calib_to_yaml(ours, w, h) == jcapture.calib_to_yaml(theirs, w, h)
    assert capture.RESOLUTIONS == jcapture.RESOLUTIONS
    out = tmp_path / "calib.yaml"
    capture.main(["calib", str(p), "-r", "720p", "-o", str(out)])
    assert out.read_text() == jcapture.calib_to_yaml(jcapture.parse_zed_conf(str(p), "720p"), 1280, 720)


def test_camera_drivers_refuse_without_their_sdk(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)  # import raises
    with pytest.raises(RuntimeError, match="pyrealsense2"):
        cameras.RealSenseCamera()
    with pytest.raises(RuntimeError, match="pyrealsense2"):
        capture.capture_l515("unused")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        cameras.ZedNativeCamera(None)
    with pytest.raises(RuntimeError, match="cv2"):
        capture.capture_zed("unused")
    t0, s0 = cameras.get_timestamp(), cameras.get_system_timestamp()
    assert cameras.get_timestamp() >= t0 and abs(s0 - time.time()) < 5.0


@pytest.fixture()
def sens_path(tmp_path):
    """tests/test_native.py's 5-frame 64x48 file (PNG colour, zlib depth)."""
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgbs, depths, poses = [], [], []
    for i in range(5):
        rgbs.append(np.stack([xx / w * 255, yy / h * 255, np.full_like(xx, 30.0 * i)], -1).astype(np.uint8))
        depths.append((1000 + 37 * i + yy * 3 + xx).astype(np.uint16))
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0.1 * i, 0, 0]
        poses.append(m)
    path = str(tmp_path / "scene.sens")
    write_sens(path, rgbs, depths, poses, np.eye(4, dtype=np.float32), depth_shift=1000.0)
    return path


@pytest.mark.parametrize("num_threads,capacity", [(3, 2), (2, 8), (1, 1)])
def test_prefetch_ordered_and_equal(sens_path, num_threads, capacity):
    """Frames decoded ahead by threads sharing one reader come in order,
    equal to another reader's `frame(i)`."""
    plain, nat = SensReader(sens_path), SensReader(sens_path)
    assert len(nat) == 5
    seen = list(nat.prefetch(num_threads=num_threads, capacity=capacity))
    assert [f.frame_id for f in seen] == [0, 1, 2, 3, 4]
    for i, f in enumerate(seen):
        ref = plain.frame(i)
        for name in ("rgb", "depth", "cam_T_world"):
            np.testing.assert_array_equal(getattr(f, name), getattr(ref, name))
        assert f.timestamp == ref.timestamp
    gen = nat.prefetch(2, 2)
    assert next(gen).frame_id == 0
    gen.close()  # an early stop cancels the frames still queued
    with pytest.raises(ValueError):
        next(nat.prefetch(0, 2))
    plain.close()
    nat.close()


def test_byte_queue_drop_semantics():
    q = ByteQueue(capacity=2)
    assert q.push(b"a") and q.push(b"bb")
    assert not q.push(b"ccc")  # full -> dropped, the producer not blocked
    assert q.dropped == 1 and len(q) == 2
    assert q.pop() == b"a"
    assert q.pop(max_bytes=1) == b"b"  # cut to max_bytes
    assert q.pop(timeout=0.05) is None  # timeout
    q.close()
    assert not q.push(b"d") and q.dropped == 1  # closed: dropped, not counted (runtime.cc)
    with pytest.raises(StopIteration):
        q.pop()
    q.destroy()


def test_byte_queue_threaded():
    """More producers than cores, a short switch interval: every item
    arrives once, each producer's in order."""
    q = ByteQueue(capacity=4)
    n_prod, per = 12, 40
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def producer(p):
            for i in range(per):
                while not q.push(bytes([p, i])):
                    time.sleep(0.0005)

        threads = [threading.Thread(target=producer, args=(p,)) for p in range(n_prod)]
        for t in threads:
            t.start()
        got = []
        while len(got) < n_prod * per:
            b = q.pop(timeout=10.0)
            assert b is not None
            got.append(b)
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    q.close()
    with pytest.raises(StopIteration):
        q.pop()
    for p in range(n_prod):
        assert [b[1] for b in got if b[0] == p] == list(range(per))
