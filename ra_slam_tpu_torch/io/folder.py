"""The `trajectory.txt` format of logged folders (counterpart of the
trajectory half of `ra_slam_tpu/io/folder.py`): one row per frame,
`id r00 r01 r02 t0 r10 ... t2`, the cam_T_world pose as 3x4.

The folder reader itself is not ported yet (it needs yaml and cv2).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def save_trajectory(path: str, entries: Sequence[Tuple[int, np.ndarray]]) -> None:
    """Write (frame_id, 3x4-or-4x4 cam_T_world) rows as `id r00 ... r23`."""
    with open(path, "w") as f:
        for fid, pose in entries:
            p = np.asarray(pose, np.float64)[:3, :4].reshape(-1)
            f.write(str(int(fid)) + " " + " ".join(f"{v:.9g}" for v in p) + "\n")


def load_trajectory(path: str) -> List[Tuple[int, np.ndarray]]:
    """Parse `trajectory.txt` rows into (id, 4x4 cam_T_world) pairs."""
    entries: List[Tuple[int, np.ndarray]] = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) != 13:
                continue
            m = np.eye(4, dtype=np.float32)
            m[:3, :4] = np.array([float(v) for v in vals[1:]], np.float32).reshape(3, 4)
            entries.append((int(vals[0]), m))
    return entries
