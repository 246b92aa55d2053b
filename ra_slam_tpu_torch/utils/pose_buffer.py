"""Thread-safe timestamped pose buffer (counterpart of
`ra_slam_tpu/utils/pose_buffer.py`).

The tracker registers (timestamp, pose) pairs, the mapper queries the
pose at a depth frame's timestamp: SLERP of the rotation and a lerp of
the translation between the two bracketing poses, clamped at the ends.
Host-side: poses are kept as float64 numpy; the tracker's device poses
are registered lazily and copied to the host together on the first read.
The counter `pose_buffer.interpolated` (`INTERPOLATED`, in
`utils/profiling.py:TRACE.counters()`) counts the queries answered
between two registered poses rather than at one.
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional

import numpy as np
import torch

from ra_slam_tpu_torch.core.se3 import SE3, mat_to_quat, quat_slerp, quat_to_mat
from ra_slam_tpu_torch.utils.profiling import TRACE


INTERPOLATED = 0  # queries that fell strictly between two registered poses
TRACE.expose("pose_buffer.interpolated", lambda: INTERPOLATED)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class PoseBuffer:
    """Monotonic timestamped cam_T_world buffer with interpolating query."""

    def __init__(self, capacity: int = 100_000):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._ts: list[float] = []
        self._quat: list[np.ndarray] = []  # (w, x, y, z) float64
        self._trans: list[np.ndarray] = []
        self._pending: list = []  # (timestamp, device SE3, device tracked flag)

    def register_lazy(self, timestamp: float, pose: SE3, valid) -> None:
        """Queue a device pose and its tracked flag without waiting for
        the device; untracked poses are dropped when the queue is read."""
        with self._lock:
            self._pending.append((timestamp, pose, valid))

    def _flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        R = _np(torch.stack([p.R for _, p, _ in pending]))
        t = _np(torch.stack([p.t for _, p, _ in pending]))
        v = _np(torch.stack([torch.as_tensor(ok) for _, _, ok in pending]))
        for k, (ts, _, _) in enumerate(pending):
            if bool(v[k]):
                self.register(ts, SE3(torch.from_numpy(R[k]), torch.from_numpy(t[k])))

    def __len__(self) -> int:
        self._flush()
        with self._lock:
            return len(self._ts)

    def register(self, timestamp: float, pose: SE3) -> None:
        """Record a valid tracked pose."""
        q = _np(mat_to_quat(pose.R.cpu())).astype(np.float64)
        t = _np(pose.t).astype(np.float64)
        with self._lock:
            if self._ts and timestamp <= self._ts[-1]:
                i = bisect.bisect_left(self._ts, timestamp)
                self._ts.insert(i, timestamp)
                self._quat.insert(i, q)
                self._trans.insert(i, t)
            else:
                self._ts.append(timestamp)
                self._quat.append(q)
                self._trans.append(t)
            if len(self._ts) > self._capacity:
                del self._ts[0], self._quat[0], self._trans[0]

    @staticmethod
    def _pose(q: np.ndarray, t: np.ndarray) -> SE3:
        R = quat_to_mat(torch.from_numpy(q)).to(torch.float32)
        return SE3(R, torch.from_numpy(t.astype(np.float32)))

    def query(self, timestamp: float) -> Optional[SE3]:
        """Pose at `timestamp`, interpolated between the bracketing
        registered poses (clamped at the ends). None if empty."""
        global INTERPOLATED
        with TRACE.wait("pose_buffer.query"):
            self._flush()
        with self._lock:
            if not self._ts:
                return None
            i = bisect.bisect_left(self._ts, timestamp)
            if i <= 0:
                q, t = self._quat[0], self._trans[0]
            elif i >= len(self._ts):
                q, t = self._quat[-1], self._trans[-1]
            else:
                t0, t1 = self._ts[i - 1], self._ts[i]
                INTERPOLATED += t0 < timestamp < t1
                u = 0.0 if t1 <= t0 else (timestamp - t0) / (t1 - t0)
                q = _np(quat_slerp(torch.from_numpy(self._quat[i - 1]), torch.from_numpy(self._quat[i]), u))
                t = (1.0 - u) * self._trans[i - 1] + u * self._trans[i]
        return self._pose(q, t)

    def latest(self) -> Optional[SE3]:
        self._flush()
        with self._lock:
            if not self._ts:
                return None
            q, t = self._quat[-1], self._trans[-1]
        return self._pose(q, t)

    def entries(self):
        """Snapshot of (timestamp, SE3) pairs."""
        self._flush()
        with self._lock:
            items = list(zip(self._ts, self._quat, self._trans))
        return [(ts, self._pose(q, t)) for ts, q, t in items]
