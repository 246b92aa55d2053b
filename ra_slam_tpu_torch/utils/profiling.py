"""Tracing and profiling utilities (counterpart of
`ra_slam_tpu/utils/profiling.py`).

`StageTimer` accumulates wall-clock spans per stage, the reference's
manual spans; `span(name, block_on=t)` first waits for the device of the
tensor(s) `t` (torch returns before a CUDA kernel ends), so the span is
the device's time too. `named_scope` is `torch.profiler.
record_function`: it names the ops inside it in a profile.
`device_trace(log_dir)` profiles the enclosed block with
`torch.profiler` (host, and the card where there is one) and writes a
Chrome trace (`log_dir/trace.json`, open in chrome://tracing or
Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

named_scope = torch.profiler.record_function


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


class StageTimer:
    """Accumulates wall-clock spans per stage name.

    with timer.span("integrate"):               # host + launch time
        step(...)
    with timer.span("integrate", block_on=m.tsdf):   # until the device is done
        step(...)
    """

    def __init__(self):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.total_s[name] += time.perf_counter() - t0
            self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        n = self.count.get(name, 0)
        return 1e3 * self.total_s[name] / n if n else 0.0

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(self.total_s[k], 4), "count": self.count[k], "mean_ms": round(self.mean_ms(k), 3)}
            for k in self.total_s
        }

    def report(self) -> str:
        return "\n".join(
            f"{k:>20s}: {v['mean_ms']:8.2f} ms x {v['count']:<5d} (total {v['total_s']:.2f} s)"
            for k, v in sorted(self.summary().items())
        )


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
