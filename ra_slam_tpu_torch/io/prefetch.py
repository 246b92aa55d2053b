"""A drop-on-overrun byte queue (counterpart of the `ByteQueue` of
`ra_slam_tpu/native/__init__.py`, without its C++ runtime: no g++ build).

`ByteQueue` has `runtime.cc`'s bounded byte-queue semantics (the data
logger / TSDF feed queue): a push to a full queue drops the item and
counts it, a push to a closed one drops it uncounted, and neither blocks;
`pop(timeout)` returns None on timeout and raises `StopIteration` once
the queue is closed and drained. The threaded `.sens` decoding of the
JAX package's native runtime is `SensReader.prefetch` (`io/sens.py`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional


class ByteQueue:
    """Bounded drop-on-overrun queue of byte blobs."""

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self._items: collections.deque = collections.deque()
        self._dropped = 0
        self._closed = False
        self._cv = threading.Condition()

    def push(self, data: bytes) -> bool:
        """True if queued, False if dropped (queue full, counted; or closed)."""
        with self._cv:
            if self._closed:
                return False
            if len(self._items) >= self.capacity:
                self._dropped += 1
                return False
            self._items.append(bytes(data))
            self._cv.notify()
            return True

    def pop(self, max_bytes: int = 1 << 22, timeout: float = -1.0) -> Optional[bytes]:
        """The oldest item (cut to `max_bytes`), waiting for one without
        end (`timeout` < 0) or up to `timeout` seconds; None on timeout;
        StopIteration once the queue is closed and drained."""
        deadline = None if timeout < 0 else time.monotonic() + timeout
        with self._cv:
            while not self._items and not self._closed:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return None
                self._cv.wait(left)
            if not self._items:
                raise StopIteration
            return self._items.popleft()[:max_bytes]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def dropped(self) -> int:
        with self._cv:
            return self._dropped

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def destroy(self) -> None:
        """Close and drop what is left (the C++ queue's free)."""
        with self._cv:
            self._closed = True
            self._items.clear()
            self._cv.notify_all()
