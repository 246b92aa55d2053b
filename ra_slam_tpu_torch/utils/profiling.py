"""Tracing and profiling utilities (counterpart of
`ra_slam_tpu/utils/profiling.py`).

`StageTimer` is the program's span registry, and `TRACE` is the one
instance that the program's stages report to: the reader
(`io/sens.py`), the facade (`pipeline/system.py`), fusion
(`map/voxel_map.py`, `models/segmentation.py`), tracking
(`slam/system.py`, `slam/tracker.py`, `features/orb.py`), the stereo
rectifier (`core/rectify.py`), the pose buffer and the kernel builds
(`ops/_build.py`).

`TRACE` is off until `TRACE.enable()`; nothing in the program enables
it. Off, `span(name)` and `wait()` return one shared no-op context: a
flag check, with no clock read, allocation or device sync. On, each
span closes into a `Record`: its name, its kind (`"work"`, or `"wait"`
for a host read of a device value, which waits for the device), its
parent record, its thread and its start and end on `time.
perf_counter_ns()`. Each thread keeps its own stack of open spans
(`SensReader.prefetch` decodes in threads, `live.run` runs two), and
`drain()` hands over the closed records and clears them. While a
`torch.profiler` is recording, each span also opens
`record_function("ra.<name>")`, which puts it in the profile beside
the kernels, on the profiler's clock. `summary()` and `report()` are
the per-name totals of every span closed since the timer was made.

A `StageTimer()` made by hand starts on, and `span(name, block_on=t)`
first waits for the device of the tensor(s) `t` (torch returns before a
CUDA kernel ends), so the span is the device's time too.

The program's counters stay in their modules (`slam.system.SYNCS`,
`tsdf_fuse.LAUNCHES`, `hamming.LAUNCHES`, `io.sens.HOST_RESIZES`,
`rectify.CALLS`, `pose_buffer.INTERPOLATED`, `orb.GRAPH_CAPTURES`,
`orb.GRAPH_REPLAYS`, `_build.BUILD_SECONDS`);
each module `expose`s its own, and `TRACE.counters()` reads them all as
they stand. They count whether or not the registry is on.

`device_trace(log_dir)` profiles the enclosed block with
`torch.profiler` (host, and the card where there is one) and writes a
Chrome trace (`log_dir/trace.json`, open in chrome://tracing or
Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

WORK, WAIT = "work", "wait"


def _synchronize(obj) -> None:
    """Wait for the CUDA device of every tensor in `obj` (a tensor, or a
    list, tuple or dict of them)."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _synchronize(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _synchronize(v)


class Record:
    """One closed span. `parent` is the span open around it on its
    thread (None at the top); times are `time.perf_counter_ns()`."""

    __slots__ = ("name", "kind", "parent", "thread", "start_ns", "end_ns")

    def __init__(self, name: str, kind: str, parent: Optional["Record"], thread: int, start_ns: int):
        self.name, self.kind, self.parent, self.thread = name, kind, parent, thread
        self.start_ns, self.end_ns = start_ns, start_ns

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def path(self) -> str:
        """The names from the outermost open span down to this one, joined
        by `/`."""
        names, r = [], self
        while r is not None:
            names.append(r.name)
            r = r.parent
        return "/".join(reversed(names))


class _Off:
    """The shared context of a span while the registry is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("timer", "name", "kind", "block_on", "record", "annotation")

    def __init__(self, timer: "StageTimer", name: str, kind: str, block_on):
        self.timer, self.name, self.kind, self.block_on = timer, name, kind, block_on

    def __enter__(self) -> Record:
        stack = self.timer._stack()
        parent = stack[-1] if stack else None
        name = self.name if self.name is not None else f"{parent.name if parent else 'program'}.wait"
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(f"ra.{name}")
            self.annotation.__enter__()
        self.record = Record(name, self.kind, parent, threading.get_ident(), time.perf_counter_ns())
        stack.append(self.record)
        return self.record

    def __exit__(self, *exc) -> bool:
        if self.block_on is not None:
            _synchronize(self.block_on)
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        self.timer._stack().pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.timer._close(rec)
        return False


class StageTimer:
    """Span registry: per-name totals, and while on, the closed spans as
    `Record`s until `drain()`.

    with timer.span("integrate"):               # host + launch time
        step(...)
    with timer.span("integrate", block_on=m.tsdf):   # until the device is done
        step(...)
    with timer.wait():                          # a host read of a device value
        flag = bool(t)
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self._records: List[Record] = []
        self._records_lock = threading.Lock()
        self._local = threading.local()
        self._counters: Dict[str, Callable[[], object]] = {}

    def enable(self, on: bool = True) -> None:
        self.enabled = on

    def span(self, name: str, block_on=None):
        """A context that times the enclosed block as `name` (the shared
        no-op while the registry is off)."""
        if not self.enabled:
            return _OFF
        return _Span(self, name, WORK, block_on)

    def wait(self, name: Optional[str] = None):
        """A `wait` span around a host read of a device value; without a
        name it is named after the stage that reads, `<stage>.wait`."""
        if not self.enabled:
            return _OFF
        return _Span(self, name, WAIT, None)

    def _stack(self) -> List[Record]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, rec: Record) -> None:
        with self._records_lock:
            self._records.append(rec)
            self.total_s[rec.name] += rec.seconds
            self.count[rec.name] += 1

    def drain(self) -> List[Record]:
        """The spans closed since the last drain, in the order they
        closed; the registry keeps none of them."""
        with self._records_lock:
            out, self._records = self._records, []
        return out

    def expose(self, name: str, read: Callable[[], object]) -> None:
        """Make a module's own counter readable as `name` by `counters()`."""
        self._counters[name] = read

    def counters(self) -> Dict[str, object]:
        """Every exposed counter's value now."""
        return {name: read() for name, read in self._counters.items()}

    def mean_ms(self, name: str) -> float:
        n = self.count.get(name, 0)
        return 1e3 * self.total_s[name] / n if n else 0.0

    def summary(self) -> Dict[str, dict]:
        with self._records_lock:  # spans may close on other threads meanwhile
            names = list(self.total_s)
        return {
            k: {"total_s": round(self.total_s[k], 4), "count": self.count[k], "mean_ms": round(self.mean_ms(k), 3)}
            for k in names
        }

    def report(self) -> str:
        return "\n".join(
            f"{k:>20s}: {v['mean_ms']:8.2f} ms x {v['count']:<5d} (total {v['total_s']:.2f} s)"
            for k, v in sorted(self.summary().items())
        )


TRACE = StageTimer(enabled=False)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Profile the enclosed block into `log_dir/trace.json` (a no-op when
    log_dir is None)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
