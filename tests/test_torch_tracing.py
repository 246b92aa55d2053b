"""The port's span registry (`ra_slam_tpu_torch.utils.profiling.TRACE`)
on the CPU: off it is one shared no-op; on, its records nest by thread
and drain once, show in a `torch.profiler` timeline inside the caller's
ranges, and cover the reader, the facade, fusion and tracking of a small
`RaSlamSystem`, whose results do not depend on it. Also the benchmark's
reduction of the records (`benchmark/harness/spans.py`)."""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import torch_parity as tp
from benchmark.harness import spans
from ra_slam_tpu_torch.core import config as tcfg
from ra_slam_tpu_torch.io.sens import COLOR_PNG, SensReader, write_sens
from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
from ra_slam_tpu_torch.slam import system as slam_system
from ra_slam_tpu_torch.utils import profiling
from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy
from ra_slam_tpu_torch.utils.profiling import TRACE, Record


@pytest.fixture
def trace_on():
    TRACE.drain()
    TRACE.enable()
    try:
        yield TRACE
    finally:
        TRACE.enable(False)
        TRACE.drain()


def test_off_span_is_the_shared_noop(monkeypatch):
    """Off, every span and wait is the one shared context: no clock read,
    no profiler check, nothing recorded."""
    assert not TRACE.enabled

    def forbidden(*a):
        raise AssertionError("read while the registry is off")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", forbidden)
    monkeypatch.setattr(profiling.torch.autograd, "_profiler_enabled", forbidden)
    noop = TRACE.span("a")
    assert noop is TRACE.span("b") is TRACE.wait() is TRACE.wait("c") is TRACE.span("d", block_on=torch.ones(1))
    with TRACE.span("off.outer"), TRACE.wait():
        pass
    assert TRACE.drain() == [] and "off.outer" not in TRACE.summary()


def test_records_nest_by_thread_and_drain_once(trace_on):
    """On, a record's parent is the span open around it on its own
    thread, an unnamed wait takes its stage's name, and drain hands each
    record over once."""
    both = threading.Barrier(2)

    def work(tag):
        with TRACE.span(f"t.outer.{tag}"):
            both.wait()
            with TRACE.span("t.inner"):
                both.wait()
                with TRACE.wait():
                    pass

    threads = [threading.Thread(target=work, args=(k,)) for k in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    recs = TRACE.drain()
    assert TRACE.drain() == []
    assert sorted(r.path() for r in recs) == sorted(
        f"t.outer.{k}{tail}" for k in "ab" for tail in ("", "/t.inner", "/t.inner/t.inner.wait"))
    for r in recs:
        assert r.end_ns >= r.start_ns
        if r.parent is not None:
            assert r.parent.thread == r.thread
            assert r.parent.start_ns <= r.start_ns and r.end_ns <= r.parent.end_ns
        assert r.kind == ("wait" if r.name == "t.inner.wait" else "work")
    assert len({r.thread for r in recs}) == 2
    assert TRACE.summary()["t.inner"]["count"] >= 2


def test_records_and_totals_survive_many_threads(trace_on):
    """More threads than cores closing spans at a short switch interval:
    no record or total is lost, and every parent is on its own thread."""
    threads, spans_each = 2 * (os.cpu_count() or 4), 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(spans_each):
                with TRACE.span("stress.outer"), TRACE.wait():
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(switch)
    recs = TRACE.drain()
    assert len(recs) == 2 * threads * spans_each
    assert all(r.parent.thread == r.thread for r in recs if r.name == "stress.outer.wait")
    s = TRACE.summary()
    assert s["stress.outer"]["count"] == s["stress.outer.wait"]["count"] == threads * spans_each


def test_profiler_ranges_nest_inside_the_callers_range(trace_on):
    """Under a torch.profiler, each span is an `ra.<name>` range of the
    profile, inside the harness's `bench.<name>` range; a span opened
    while no profiler records opens none."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.read"):
            with TRACE.span("sens.frame"):
                with TRACE.span("sens.color"):
                    (x * 2).sum()
    with TRACE.span("after"):
        pass
    ev = {e.name: e.time_range for e in prof.events() if e.device_type == DeviceType.CPU}
    bench, frame, color = ev["bench.read"], ev["ra.sens.frame"], ev["ra.sens.color"]
    assert bench.start <= frame.start <= color.start and color.end <= frame.end <= bench.end
    assert "ra.after" not in ev
    assert [r.path() for r in TRACE.drain()] == ["sens.frame/sens.color", "sens.frame", "after"]


def test_idle_gap_label_is_the_innermost_program_span():
    bench = [(0.0, 100.0, "read"), (100.0, 180.0, "feed_rgbd")]
    program = [(1.0, 99.0, "sens.frame"), (2.0, 40.0, "sens.color"), (41.0, 98.0, "sens.resize"),
               (101.0, 170.0, "facade.feed_rgbd")]
    assert spans.label_gap((50.0, 90.0), bench, program) == "read/sens.resize"
    assert spans.label_gap((10.0, 20.0), bench, program) == "read/sens.color"
    assert spans.label_gap((171.0, 179.0), bench, program) == "feed_rgbd"
    assert spans.label_gap((181.0, 190.0), bench, program) == "between calls"


def _rec(name, a, b, parent=None, kind="work"):
    r = Record(name, kind, parent, 1, a)
    r.end_ns = b
    return r


def test_frame_quantities_of_synthetic_records():
    """The per-layer quantities of two synthetic frames: a tracked and
    fused one with a keyframe, and a tracked one that fusion skipped."""
    ms = 1_000_000
    recs = []
    # frame 0: [0, 100) ms
    f0 = _rec("sens.frame", 0, 30 * ms)
    recs += [f0, _rec("sens.color", 0, 10 * ms, f0), _rec("sens.resize", 10 * ms, 25 * ms, f0)]
    tr = _rec("facade.feed_tracking", 30 * ms, 70 * ms)
    step = _rec("slam.step", 45 * ms, 69 * ms, tr)
    recs += [tr, _rec("slam.detect", 31 * ms, 44 * ms, tr), step,
             _rec("slam.step.wait", 46 * ms, 48 * ms, step, "wait"),
             _rec("slam.keyframe", 50 * ms, 68 * ms, step),
             _rec("frame_info.pull", 70 * ms, 71 * ms, None, "wait")]
    fr = _rec("facade.feed_rgbd", 72 * ms, 99 * ms)
    recs += [fr, _rec("seg.segment", 73 * ms, 80 * ms, fr), _rec("map.integrate_frame", 80 * ms, 95 * ms, fr),
             _rec("facade.stats", 95 * ms, 98 * ms, fr, "wait")]
    # frame 1: [100, 200) ms, no keyframe, not fused
    f1 = _rec("sens.frame", 100 * ms, 120 * ms)
    tr1 = _rec("facade.feed_tracking", 120 * ms, 150 * ms)
    recs += [f1, _rec("sens.color", 100 * ms, 108 * ms, f1), tr1, _rec("slam.detect", 121 * ms, 140 * ms, tr1),
             _rec("frame_info.pull", 150 * ms, 154 * ms, None, "wait"),
             _rec("late", 250 * ms, 260 * ms)]  # outside every frame
    per = spans.assign(recs, [(0, 100 * ms), (100 * ms, 200 * ms)])
    assert sum(map(len, per)) == len(recs) - 1
    frames = [spans.frame_totals(per[0], (30 * ms, 72 * ms)), spans.frame_totals(per[1], (120 * ms, 155 * ms))]
    frames[0]["syncs"], frames[1]["syncs"] = 3, 2
    q = spans.quantities(frames)
    want = {"read_color_ms.sens": 9.0, "read_resize_ms.sens": 7.5, "segment_ms.fuse": 7.0,
            "integrate_ms.fuse": 15.0, "wait_ms.fuse": 3.0, "detect_ms.rgbd": 16.0, "keyframe_ms.rgbd": 18.0,
            "wait_ms.track": 3.5, "syncs_per_frame.track": 2.5}
    assert set(q) == set(want)
    for k, v in want.items():
        assert q[k] == pytest.approx(v), k
    assert spans.quantities([spans.frame_totals([])]) == dict.fromkeys(want)


# the facade at tests/torch_parity.py's size, tracking with few landmarks
# and a keyframe every other frame, so that nine frames reach a loop check
TRACK = dict(max_map_points=2048, max_keyframes=16, keyframe_min_interval=1, keyframe_translation=0.0)
FRAMES = 9


def _system_cfg():
    c = tp.CAM_KW
    return tcfg.SystemConfig(
        camera=tcfg.CameraConfig(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                                 height=c["height"]),
        tsdf=tp.torch_cfg(), feature=tcfg.FeatureConfig(max_num_keypoints=300, num_levels=2),
        tracking=tcfg.TrackingConfig(**TRACK),
    )


@pytest.fixture(scope="module")
def sens_path(tmp_path_factory):
    """A PNG `.sens` of the synthetic orbit, colour at twice the depth
    size (so the reader resizes it)."""
    ds = SyntheticBoxDataset(num_frames=120, cam=SyntheticCameraSpec(**tp.CAM_KW), radius=1.0, seed=0)
    frames = [ds.frame(i) for i in range(FRAMES)]
    path = str(tmp_path_factory.mktemp("sens") / "orbit.sens")
    k = np.array([[80.0, 0, 79.5], [0, 80.0, 59.5], [0, 0, 1]], np.float32)
    write_sens(path, [np.repeat(np.repeat(f.rgb, 2, 0), 2, 1) for f in frames],
               [np.round(f.depth * 1000.0).astype(np.uint16) for f in frames],
               [np.linalg.inv(f.cam_T_world).astype(np.float32) for f in frames], k,
               color_compression=COLOR_PNG, device="cpu")
    return path


def _replay(path):
    """Each frame read, tracked, then fused at its tracked pose. Returns
    (map, poses, info fields, tracker host reads a frame)."""
    reader = SensReader(path)
    system = RaSlamSystem(_system_cfg(), "cpu", enable_tracking=True)
    poses, infos, syncs = [], [], []
    for i in range(len(reader)):
        before = TRACE.counters()["slam.syncs"]
        f = reader.frame(i)
        info = system.feed_tracking_frame(f.rgb, f.depth, f.timestamp)
        infos.append((info.tracked, info.num_inliers, info.inserted_keyframe, info.loop_cand))
        poses.append((info.pose.R.clone(), info.pose.t.clone()))
        system.feed_rgbd_frame(f.rgb, f.depth, f.timestamp)
        syncs.append(TRACE.counters()["slam.syncs"] - before)
    return system.map, poses, infos, syncs


def test_system_records_its_span_tree_and_is_unchanged(sens_path):
    """A small system replaying a `.sens` file: with the registry on, the
    records form the span tree of the reader, the facade, fusion and
    tracking; the map, the poses, the frame fields and the tracker's
    host reads (`SYNCS`, read through `TRACE.counters()`) are the same
    bit for bit as with it off."""
    assert TRACE.counters()["slam.syncs"] == slam_system.SYNCS
    off = _replay(sens_path)
    assert TRACE.drain() == []
    TRACE.enable()
    try:
        on = _replay(sens_path)
    finally:
        TRACE.enable(False)
    recs = TRACE.drain()
    paths = {r.path() for r in recs}
    track = "facade.feed_tracking/slam.step"
    fuse = "facade.feed_rgbd/map.integrate_frame"
    want = {
        "sens.frame/sens.color", "sens.frame/sens.resize", "sens.frame/sens.depth",
        "facade.feed_tracking/slam.upload", "facade.feed_tracking/slam.detect/orb.pyramid",
        "facade.feed_tracking/slam.detect/orb.levels", "facade.feed_tracking/pose_buffer.register",
        f"{track}/slam.init", f"{track}/slam.record", f"{track}/slam.step.wait",
        f"{track}/slam.track/track.match", f"{track}/slam.track/track.gn",
        f"{track}/slam.keyframe/slam.keyframe.wait", f"{track}/slam.keyframe/slam.loop_check",
        "frame_info.pull", "facade.feed_rgbd/slam.lost",
        "facade.feed_rgbd/facade.pose_query/pose_buffer.query",
        "facade.feed_rgbd/facade.upload", "facade.feed_rgbd/seg.segment", "facade.feed_rgbd/facade.stats",
        f"{fuse}/map.allocate", f"{fuse}/map.cull", f"{fuse}/map.prep", f"{fuse}/map.fuse", f"{fuse}/map.carve",
    }
    assert want <= paths, want - paths
    waits = {"slam.step.wait", "slam.keyframe.wait", "frame_info.pull", "slam.lost", "pose_buffer.query",
             "facade.stats"}
    assert all((r.kind == "wait") == (r.name in waits) for r in recs)
    counts = {n: sum(r.name == n for r in recs) for n in ("sens.frame", "facade.feed_tracking", "slam.init")}
    assert counts == {"sens.frame": FRAMES, "facade.feed_tracking": FRAMES, "slam.init": 1}
    (m0, poses0, infos0, syncs0), (m1, poses1, infos1, syncs1) = off, on
    assert syncs0 == syncs1 and infos0 == infos1
    assert sum(r.name.endswith(".wait") for r in recs) == sum(syncs1)
    for (r0, t0), (r1, t1) in zip(poses0, poses1):
        assert torch.equal(r0, r1) and torch.equal(t0, t1)
    a, b = voxel_map_to_numpy(m0), voxel_map_to_numpy(m1)
    for name in ("key", "value"):
        np.testing.assert_array_equal(getattr(a.table, name), getattr(b.table, name))
    for name, v in vars(a).items():
        if name != "table":
            np.testing.assert_array_equal(v, getattr(b, name), err_msg=name)
