"""The `--trace 1` run's device trace: `torch.profiler` over a stretch of
the window, reduced to what the per-layer metrics read.

The profiler records CPU and CUDA activity over a fixed number of frames.
The harness marks each of its own calls into the program with a
`record_function` span (`bench.<name>`), so that the device's idle gaps
can be named by what the host was doing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def busy_us(intervals) -> float:
    """Length of the union of the (start, end) intervals."""
    busy, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (cur[1] - cur[0] if cur else 0.0)


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle (start, end) stretches of [lo, hi] outside the intervals."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return [g for g in out if g[1] > g[0]]


@dataclass
class TraceSummary:
    frames: int  # frames inside the traced stretch
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]  # device seconds by kernel / op name
    kernel_n: Dict[str, int]  # device records by name
    launches: int  # host-side kernel launch calls
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


class Tracer:
    """Profiles frames [start, start + count) of the window when enabled."""

    def __init__(self, enabled: bool, start: int, count: int, device="cuda"):
        self.enabled, self.start, self.count, self.device = enabled, start, count, device
        self.prof = None
        self.t0 = self.t1 = None
        self.frames = 0
        self.done = False

    def active(self) -> bool:
        return self.prof is not None and not self.done

    def before_frame(self, i: int) -> None:
        if not self.enabled or self.done or self.prof is not None or i < self.start:
            return
        from torch.profiler import ProfilerActivity, profile

        from .dev import sync

        sync(self.device)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if str(self.device).startswith("cuda") else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def after_frame(self) -> None:
        if not self.active():
            return
        self.frames += 1
        if self.frames >= self.count:
            self.stop()

    def stop(self) -> None:
        if not self.active():
            return
        from .dev import sync

        sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.done = True

    def reduce(self) -> Optional[TraceSummary]:
        """The summary of the traced stretch (after the window: reading
        the events takes seconds)."""
        if self.prof is None or not self.done:
            return None
        summary = self._reduce()
        self.prof = None
        return summary

    def _reduce(self) -> TraceSummary:
        from torch.autograd import DeviceType

        events = list(self.prof.events())
        # the harness's own record_function spans appear on the device too,
        # as annotations: they are no device work
        dev = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith("bench.")
               and not getattr(e, "is_user_annotation", False)]
        host = [e for e in events if e.device_type == DeviceType.CPU]
        ivals = [(e.time_range.start, e.time_range.end) for e in dev]
        k_s: Dict[str, float] = {}
        k_n: Dict[str, int] = {}
        for e in dev:
            k_s[e.name] = k_s.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
            k_n[e.name] = k_n.get(e.name, 0) + 1
        launches = sum(1 for e in host if e.name in LAUNCH_CALLS)
        spans = [(e.time_range.start, e.time_range.end, e.name[len("bench."):])
                 for e in host if e.name.startswith("bench.")]
        lo = min([s[0] for s in spans] + [a for a, _ in ivals], default=0.0)
        hi = max([s[1] for s in spans] + [b for _, b in ivals], default=0.0)
        longest = sorted(gaps(ivals, lo, hi), key=lambda g: g[0] - g[1])[:10]
        labelled = []
        for a, b in longest:
            mid = 0.5 * (a + b)
            inner = [s for s in spans if s[0] <= mid <= s[1]]
            name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "between calls"
            labelled.append([name, (b - a) * 1e-6])
        top = sorted(k_s.items(), key=lambda kv: -kv[1])[:10]
        return TraceSummary(
            frames=self.frames,
            window_s=self.t1 - self.t0,
            busy_s=busy_us(ivals) * 1e-6,
            kernel_s=k_s,
            kernel_n=k_n,
            launches=launches,
            device_ops=[[n, s] for n, s in top],
            idle_gaps=labelled,
        )
