"""A cell of the benchmark shrunk to run on the CPU in seconds: the same
configuration and traffic files with smaller frames, map and walk."""

from __future__ import annotations

import copy
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.spec import load_cell  # noqa: E402


def small_cell(workload: str, frames: int = 6):
    cell = copy.deepcopy(load_cell(workload, ROOT))
    c, t = cell.config, cell.traffic
    c["depth_camera"].update(fx=86.6, fy=86.8, cx=47.8, cy=32.3, width=96, height=64)
    c["color"].update(width=194, height=129)
    c["map"].update(log2_num_blocks=14, log2_hash_size=16, max_visible_blocks=4096, max_new_blocks=4096)
    c["room"]["clutter"] = 3
    t.update(session_frames=frames, warmup_frames=2, trace_after_frames=1, trace_frames=2, check_color_frames=2)
    return cell


def args(seed: int = 3, seconds: float = 0.5, trace: int = 0):
    return SimpleNamespace(workload="small", seed=seed, seconds=seconds, trace=trace)


def cv2_decode_jpeg(data: bytes):
    """The program decodes JPEG with nvjpeg, which needs a card: on the
    CPU the tests decode with libjpeg in its place."""
    import cv2
    import numpy as np

    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1].copy()
