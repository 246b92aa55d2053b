"""Asynchronous data logger (counterpart of
`ra_slam_tpu/utils/data_logger.py`).

Producers enqueue without blocking; a daemon thread drains and writes;
when the writer cannot keep up, the new item is dropped and counted
(the reference's double-buffered logger). `FrameLogger` dumps frames
into the logged-folder layout that `io/folder.py:FolderReader` replays:
`{id}_rgb.png` (8-bit RGB), `{id}_depth.png` (16-bit, depth *
depth_factor), and the `{id}_ht.png` / `{id}_no_ht.png` maps (8-bit,
prob * 255), all through `io/png.py`.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Callable, Generic, List, Optional, Tuple, TypeVar

import numpy as np

from ra_slam_tpu_torch.io.png import write_png

T = TypeVar("T")
log = logging.getLogger("ra_slam_tpu_torch")


class AsyncLogger(Generic[T]):
    """Background-thread writer with bounded buffering and drop counting."""

    def __init__(self, write_fn: Callable[[T], None], capacity: int = 32):
        self._write_fn = write_fn
        self._q: "queue.Queue[T]" = queue.Queue(maxsize=capacity)
        self._dropped = 0
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def log(self, item: T) -> bool:
        """Enqueue; False (and a counted drop) when full."""
        if self._closed:
            return False
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            self._dropped += 1
            log.warning("AsyncLogger overrun: dropped item (%d total)", self._dropped)
            return False

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write_fn(item)
            except Exception:  # the writer thread must outlive a failed write
                log.exception("AsyncLogger write failed")

    @property
    def dropped(self) -> int:
        return self._dropped

    def close(self) -> None:
        """Flush and join."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join()


class FrameLogger:
    """Logs (frame_id, rgb, depth[, ht, lt]) to the logged-folder layout
    and records the ids for trajectory matching."""

    def __init__(self, folder: str, depth_factor: float = 1000.0, capacity: int = 32):
        os.makedirs(folder, exist_ok=True)
        self.folder = folder
        self.depth_factor = depth_factor
        self.logged_ids: List[int] = []
        self._logger: AsyncLogger = AsyncLogger(self._write, capacity)

    def log_frame(self, frame_id: int, rgb: np.ndarray, depth: np.ndarray, ht: Optional[np.ndarray] = None,
                  lt: Optional[np.ndarray] = None) -> bool:
        ok = self._logger.log((frame_id, rgb, depth, ht, lt))
        if ok:
            self.logged_ids.append(frame_id)
        return ok

    def _write(self, item: Tuple) -> None:
        fid, rgb, depth, ht, lt = item
        path = lambda suffix: os.path.join(self.folder, f"{fid}_{suffix}.png")
        write_png(path("rgb"), np.asarray(rgb, np.uint8))
        raw = np.clip(np.asarray(depth, np.float32) * self.depth_factor, 0, 65535).astype(np.uint16)
        write_png(path("depth"), raw)
        for suffix, m in (("ht", ht), ("no_ht", lt)):
            if m is not None:
                write_png(path(suffix), (np.clip(m, 0, 1) * 255).astype(np.uint8))

    def save_trajectory(self, entries) -> None:
        """Write the trajectory of the logged frames (the reference's
        `SaveMatchedTrajectory` flow)."""
        from ra_slam_tpu_torch.io.folder import save_trajectory

        logged = set(self.logged_ids)
        save_trajectory(os.path.join(self.folder, "trajectory.txt"), [(fid, m) for fid, m in entries if fid in logged])

    @property
    def dropped(self) -> int:
        return self._logger.dropped

    def close(self) -> None:
        self._logger.close()
