"""The program's own spans (`ra_slam_tpu_torch.utils.profiling.TRACE`),
given to the frames of a replay and reduced to per-frame quantities.

A frame is the host interval from its read to the end of its last call
into the program, on `time.perf_counter_ns()`, the clock the registry's
records carry: a record belongs to the frame in whose interval it
starts. `label_gap` names a device idle gap by the harness's innermost
`bench.<name>` range and the program's innermost `ra.<name>` range
around its middle (the profiler's host events, on the kernels' clock).

Nothing here imports the program: a checkout whose program has no
registry yields no records, and every quantity is then None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

WAIT = "wait"


def assign(records, bounds: Sequence[Tuple[int, int]]) -> List[list]:
    """The records that start inside each (start_ns, end_ns) interval;
    `bounds` sorted and disjoint."""
    out: List[list] = [[] for _ in bounds]
    starts = [a for a, _ in bounds]
    for r in records:
        i = bisect.bisect_right(starts, r.start_ns) - 1
        if i >= 0 and r.start_ns < bounds[i][1]:
            out[i].append(r)
    return out


def _inside(rec, name: str) -> bool:
    r = rec.parent
    while r is not None:
        if r.name == name:
            return True
        r = r.parent
    return False


def frame_totals(recs, track: Optional[Tuple[int, int]] = None) -> Dict[str, float]:
    """Seconds by span name over one frame's records, and two sums of
    its `wait` spans: `wait.feed_rgbd`, inside `facade.feed_rgbd`, and
    `wait.track`, those that start inside the frame's tracking interval
    `track` (the call, and the harness's read of its flag)."""
    out: Dict[str, float] = {"wait.feed_rgbd": 0.0, "wait.track": 0.0}
    for r in recs:
        out[r.name] = out.get(r.name, 0.0) + r.seconds
        if r.kind != WAIT:
            continue
        if _inside(r, "facade.feed_rgbd"):
            out["wait.feed_rgbd"] += r.seconds
        if track is not None and track[0] <= r.start_ns < track[1]:
            out["wait.track"] += r.seconds
    return out


# quantity -> (span total, frames it is a mean over)
QUANTITIES = {
    "read_color_ms.sens": ("sens.color", "sens.frame"),
    "read_resize_ms.sens": ("sens.resize", "sens.frame"),
    "segment_ms.fuse": ("seg.segment", "facade.feed_rgbd"),
    "integrate_ms.fuse": ("map.integrate_frame", "facade.feed_rgbd"),
    "wait_ms.fuse": ("wait.feed_rgbd", "facade.feed_rgbd"),
    "detect_ms.rgbd": ("slam.detect", "facade.feed_tracking"),
    "keyframe_ms.rgbd": ("slam.keyframe", "slam.keyframe"),
    "wait_ms.track": ("wait.track", "facade.feed_tracking"),
}


def quantities(frames: List[dict]) -> Dict[str, Optional[float]]:
    """Per-frame means, in ms, of `QUANTITIES` over the frames that ran
    the named span (each frame a `frame_totals` dict; a replay that
    tracks adds `syncs`, the tracker's host reads over the frame), and
    `syncs_per_frame.track`, the mean of `syncs` over the tracked
    frames."""
    out: Dict[str, Optional[float]] = {}
    for name, (key, over) in QUANTITIES.items():
        xs = [f.get(key, 0.0) for f in frames if over in f]
        out[name] = 1e3 * sum(xs) / len(xs) if xs else None
    syncs = [f["syncs"] for f in frames if "facade.feed_tracking" in f and "syncs" in f]
    out["syncs_per_frame.track"] = sum(syncs) / len(syncs) if syncs else None
    return out


def _innermost(spans, t: float) -> Optional[str]:
    inner = [s for s in spans if s[0] <= t <= s[1]]
    return min(inner, key=lambda s: s[1] - s[0])[2] if inner else None


def label_gap(gap: Tuple[float, float], bench, program) -> str:
    """`bench/program`: the innermost harness range and the innermost
    program range (each a list of (start, end, name)) around the gap's
    middle; `between calls` outside every harness range."""
    mid = 0.5 * (gap[0] + gap[1])
    outer, inner = _innermost(bench, mid), _innermost(program, mid)
    if outer is None:
        return "between calls" if inner is None else inner
    return outer if inner is None else f"{outer}/{inner}"
