"""Where the time of a replayed ScanNet frame goes inside ra_slam_tpu_torch,
by the program's own spans (`ra_slam_tpu_torch/utils/profiling.py:TRACE`),
on one NVIDIA GPU.

    python3 scripts/trace_torch_replay.py --workload scannet_gt_seg --seed 7 \\
        [--seconds 51] [--profile-frames 40] [--out runs/spans_gt.json]

It replays a benchmark cell (`BENCHMARK.json`): the cell's inputs made
from the seed, each frame read, tracked where the cell tracks, and fused,
one at a time, with the calls of `benchmark/loops/rgbd_replay.py`. For
`--seconds` the registry is on for a seeded random half of the frames and
off for the rest. Reported:
  - the per-layer quantities of `benchmark/harness/spans.py`, means over
    the frames with the registry on;
  - each call's host time (read, track, feed) over the frames with the
    registry on and off, and the share by which on exceeds off: its cost;
  - the mean per frame of every span path, the spans a frame, one span's
    host cost on and off, and the registry's counters;
then over `--profile-frames` more frames, the registry on, under
torch.profiler: the device's idle share (the harness's count, and with
the program's `ra.` device ranges left out too), the launches a frame,
the ten longest idle gaps labelled `<harness call>/<innermost program
span>`, and the mean `facade.feed_rgbd` of the registry against the
profiler's range of it. One JSON line, with the card's nvidia-smi name
and power limit; `--out` writes it to a file too.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _mean(xs):
    return statistics.fmean(xs) if xs else None


class Replay:
    """The cell's program and frames, stepped one frame at a time as the
    benchmark's loop steps them."""

    def __init__(self, cell, seed: int, device, work: Path):
        from benchmark.harness import inputs
        from benchmark.loops import rgbd_replay
        from ra_slam_tpu_torch.io.sens import SensReader
        from ra_slam_tpu_torch.pipeline.system import RaSlamSystem

        cfg, tr = cell.config, cell.traffic
        self.use_slam = bool(tr["use_slam"])
        seq = inputs.make_rgbd_sequence(cfg, tr, seed, device, str(work / "sequence.sens"))
        ckpt = str(work / "segmentation.msgpack")
        inputs.make_segmentation_weights(cfg, seed, device, ckpt)
        sys_cfg = rgbd_replay._system_config(cfg)
        self.new_system = lambda: RaSlamSystem(sys_cfg, device, segmentation_model=ckpt,
                                               enable_tracking=self.use_slam,
                                               alloc_stride=cfg["map"]["alloc_stride"])
        self.reader = SensReader(seq.path)
        self.system, self.i = None, 0

    def step(self, rf) -> dict:
        """One frame, a new session at the walk's start; its host clock
        stamps (ns) and the tracker's host reads over it."""
        from ra_slam_tpu_torch.core.se3 import SE3
        from ra_slam_tpu_torch.utils.profiling import TRACE

        import torch

        if self.system is None or self.i == len(self.reader):
            self.system = None
            gc.collect()
            self.system, self.i = self.new_system(), 0
        i, clock = self.i, time.perf_counter_ns
        self.i += 1
        syncs = TRACE.counters().get("slam.syncs", 0)
        a = clock()
        with rf("bench.read"):
            f = self.reader.frame(i)
        b = clock()
        tracked, c = True, b
        if self.use_slam:
            with rf("bench.track"):
                info = self.system.feed_tracking_frame(f.rgb, f.depth, f.timestamp)
                tracked = bool(info.tracked)
            c = clock()
        fused = False
        if tracked:
            with rf("bench.feed_rgbd"):
                given = None if self.use_slam else SE3.from_matrix(torch.from_numpy(f.cam_T_world))
                fused = "skipped" not in self.system.feed_rgbd_frame(f.rgb, f.depth, f.timestamp, pose=given)
        d = clock()
        return dict(a=a, b=b, c=c, d=d, fused=fused, tracked=self.use_slam,
                    syncs=TRACE.counters().get("slam.syncs", 0) - syncs)


def _calls_ms(frames) -> dict:
    """Mean host ms of each call over the frames."""
    return {"read": _mean([1e-6 * (f["b"] - f["a"]) for f in frames]),
            "track": _mean([1e-6 * (f["c"] - f["b"]) for f in frames if f["tracked"]]),
            "feed": _mean([1e-6 * (f["d"] - f["c"]) for f in frames if f["fused"]])}


def window(replay, seconds: float, seed: int) -> dict:
    """`seconds` of frames, the registry on for a random half of them."""
    from benchmark.harness import spans
    from ra_slam_tpu_torch.utils.profiling import TRACE

    rng = np.random.default_rng(seed)
    nullrf = lambda name: contextlib.nullcontext()
    frames, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        on = bool(rng.random() < 0.5)
        TRACE.enable(on)
        f = replay.step(nullrf)
        TRACE.enable(False)
        f["on"] = on
        frames.append(f)
    on = [f for f in frames if f["on"]]
    recs = TRACE.drain()
    per = spans.assign(recs, [(f["a"], f["d"]) for f in on])
    totals, paths = [], defaultdict(float)
    for f, rs in zip(on, per):
        t = spans.frame_totals(rs, (f["b"], f["c"]) if f["tracked"] else None)
        if f["tracked"]:
            t["syncs"] = f["syncs"]
        totals.append(t)
        for r in rs:
            paths[r.path()] += r.seconds
    calls_on, calls_off = _calls_ms(on), _calls_ms([f for f in frames if not f["on"]])
    feed_rgbd = [t["facade.feed_rgbd"] for t in totals if "facade.feed_rgbd" in t]
    return {
        "frames": len(frames), "frames_on": len(on), "spans_per_frame": sum(map(len, per)) / len(on),
        "quantities": spans.quantities(totals),
        "calls_ms_on": calls_on, "calls_ms_off": calls_off,
        "on_cost_pct": {k: 100.0 * (calls_on[k] / calls_off[k] - 1.0)
                        for k in calls_on if calls_on[k] and calls_off[k]},
        "facade_feed_rgbd_ms": 1e3 * _mean(feed_rgbd) if feed_rgbd else None,
        "syncs_per_frame_off": _mean([f["syncs"] for f in frames if f["tracked"] and not f["on"]]),
        "span_ms_per_frame": {p: 1e3 * s / len(on) for p, s in sorted(paths.items())},
    }


def profile(replay, n: int, device) -> dict:
    """`n` frames, the registry on, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from benchmark.harness import spans
    from benchmark.harness.dev import sync
    from benchmark.harness.trace import LAUNCH_CALLS, busy_us, gaps
    from ra_slam_tpu_torch.utils.profiling import TRACE

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    TRACE.drain()
    TRACE.enable()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            replay.step(torch.profiler.record_function)
        sync(device)
        window_s = time.perf_counter() - t0
    TRACE.enable(False)
    recs = TRACE.drain()
    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    # the harness's device work (benchmark/harness/trace.py), and the same
    # with the program's ranges left out too
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith("bench.")
           and not getattr(e, "is_user_annotation", False)]
    work = [e for e in dev if not e.name.startswith("ra.")]
    ival = lambda es: [(e.time_range.start, e.time_range.end) for e in es]
    bench = [(e.time_range.start, e.time_range.end, e.name[len("bench."):]) for e in host
             if e.name.startswith("bench.")]
    program = [(e.time_range.start, e.time_range.end, e.name[len("ra."):]) for e in host if e.name.startswith("ra.")]
    lo = min([s[0] for s in bench] + [a for a, _ in ival(work)], default=0.0)
    hi = max([s[1] for s in bench] + [b for _, b in ival(work)], default=0.0)
    longest = sorted(gaps(ival(work), lo, hi), key=lambda g: g[0] - g[1])[:10]
    prof_feed = [(e.time_range.end - e.time_range.start) * 1e-3 for e in host if e.name == "ra.facade.feed_rgbd"]
    reg_feed = [r.seconds * 1e3 for r in recs if r.name == "facade.feed_rgbd"]
    return {
        "frames": n, "window_s": window_s,
        "device_idle_pct": 100.0 * (1.0 - busy_us(ival(dev)) * 1e-6 / window_s),
        "device_idle_pct_without_ra": 100.0 * (1.0 - busy_us(ival(work)) * 1e-6 / window_s),
        "ra_device_events": len(dev) - len(work),
        "launches_per_frame": sum(1 for e in host if e.name in LAUNCH_CALLS) / n,
        "idle_gaps": [[spans.label_gap(g, bench, program), (g[1] - g[0]) * 1e-6] for g in longest],
        "facade_feed_rgbd_ms": {"registry": _mean(reg_feed), "profiler": _mean(prof_feed)},
    }


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds of one span opened and closed inside another,
    the registry on and off, with no profiler recording."""
    from ra_slam_tpu_torch.utils.profiling import TRACE

    out = {}
    for on in (True, False):
        TRACE.enable(on)
        with TRACE.span("cost.outer"):
            t = time.perf_counter_ns()
            for _ in range(n):
                with TRACE.span("cost.inner"):
                    pass
            out["on" if on else "off"] = (time.perf_counter_ns() - t) * 1e-3 / n
        TRACE.enable(False)
        TRACE.drain()
    return out


def measure(cell, seed: int, seconds: float, profile_frames: int, device) -> dict:
    from ra_slam_tpu_torch.utils.profiling import TRACE

    out = {"workload": cell.name, "seed": seed, "span_cost_us": span_cost_us()}
    with tempfile.TemporaryDirectory(prefix="trace_replay_") as work:
        t = time.perf_counter()
        replay = Replay(cell, seed, device, Path(work))
        TRACE.enable()  # the warm-up pays every first call, spans included
        for _ in range(cell.traffic["warmup_frames"]):
            replay.step(lambda name: contextlib.nullcontext())
        TRACE.enable(False)
        TRACE.drain()
        out["setup_s"] = time.perf_counter() - t
        out["window"] = window(replay, seconds, seed)
        if profile_frames:
            out["profile"] = profile(replay, profile_frames, device)
    out["counters"] = TRACE.counters()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--profile-frames", type=int, default=40)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from benchmark.run import HOST_THREADS, card_line, prepare_env

    prepare_env()
    import torch

    torch.set_num_threads(HOST_THREADS)
    from benchmark.harness.spec import load_cell

    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    out = measure(load_cell(args.workload, ROOT), args.seed, args.seconds, args.profile_frames, device)
    out["card"] = card_line()
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
