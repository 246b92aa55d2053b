"""`correct` in the ZED-alone replay (`zed_sdk_dense_replay`) on the CPU,
at a small size (the ZED at a fifth of HD720, D = 32, the map at half
the ZED's size, 4 pyramid levels, 8 pairs): a sound run passes, and the
control and each fault fail. The reference it is held against loads
neither JAX nor the program.

Faults planted underneath the timed path:
- the views swapped: the right image passed as the left to the dense
  depth;
- the left-right check skipped;
- half the disparity range searched;
- each pair's depth fused at the previous pair's pose;
- every third pair's left view rectified a row off.
"""

from __future__ import annotations

import copy

import pytest
import torch

from small import ROOT, args

from benchmark import calibrate, run
from benchmark.harness.spec import load_cell, load_module
from benchmark.reference.compare import judge
from test_bench_imports import FORBIDDEN, _top_level_after

CELL = "zed_sdk_dense_replay"


def small_zed_cell(pairs: int = 8):
    cell = copy.deepcopy(load_cell(CELL, ROOT))
    c, t = cell.config, cell.traffic
    z = c["zed"]
    s = 0.2  # HD720 / 5: 256 x 144
    for side in ("left", "right"):
        cam = z["calibration"][side]
        cam.update(fx=cam["fx"] * s, fy=cam["fy"] * s, cx=(cam["cx"] + 0.5) * s - 0.5, cy=(cam["cy"] + 0.5) * s - 0.5)
    z.update(width=256, height=144)
    c["dense_stereo"].update(max_disparity=32)
    c["keypoint_max_disparity"] = 64  # the program's search at a fifth of HD720 (fx b ~ 16 px m)
    c["map"].update(voxel_size=0.04, truncation=0.24, log2_num_blocks=14, log2_hash_size=16,
                    max_visible_blocks=4096, max_new_blocks=4096, width=128, height=72)
    c["depth_camera"].update(width=128, height=72)
    c["tracking"].update(max_num_keypoints=300, num_levels=4)
    c["room"]["clutter"] = 3
    t.update(zed_pairs=pairs, warmup_cycles=2, trace_after_cycles=1, trace_cycles=2, check_pairs=2)
    return cell


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads a test: the tests share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _run(seed=2**31 + 7, seconds=8.0):
    res = run.run_cell(small_zed_cell(), args(seed=seed, seconds=seconds), torch.device("cpu"), load_module)
    assert res is not None
    return res


def test_the_reference_loads_neither_jax_nor_the_program():
    mods = _top_level_after("import benchmark.reference.dense_stereo, benchmark.harness.stereo_work")
    assert "torch" in mods and not mods & (FORBIDDEN | {"ra_slam_tpu_torch"})


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["check"]
    c = res["counters"]
    assert res["failed"] == 0 and c["frames_fused"] == c["zed_calls"] >= 1
    assert c["stereo.dense_calls"] == c["zed_calls"] and c["pose_buffer.interpolated"] == 0
    assert c["stereo.dense_entries"] == c["zed_calls"] * 256 * 144 * 32


def test_traced_run_reads_the_dense_stage(tmp_path):
    """`--trace 1` reads the program's `stereo.dense`, `slam.stereo_depth`
    and `facade.feed_rgbd` spans, counts the traced pairs' dense ranges
    and their fusion's work (the CPU profile has no device time, so the
    rooflines read nothing here)."""
    cell = small_zed_cell()
    cell.traffic.update(trace_after_cycles=0, trace_cycles=1)  # the profiler slows a CPU cycle to seconds
    out = load_module("loops", cell.traffic["loop"]).run(
        run.Context(cell, 2**31 + 7, 20.0, True, torch.device("cpu"), tmp_path))
    for name in ("dense_depth_ms.zed", "stereo_depth_ms.zed", "feed_rgbd_ms.l515"):
        assert load_module("metrics", name).read(out, cell) > 0, name
    assert out["dense"]["calls"] == 1 and out["counters"]["traced_d2h"] == 0
    (visible, updated), = out["counters"]["traced_work"]
    assert visible > 0 and updated > 0
    for name in ("dense_stereo_roofline", "fuse_roofline"):
        assert load_module("metrics", name).read(out, cell) is None, name


def test_device_time_is_read_by_the_range_around_its_launch():
    """The traced run's device time by program stage, on a profile made
    by hand (a CPU profile has no device records): each device record is
    counted in every range around the host operation that launched it,
    and a device-to-host copy under the dense stage or the upload is
    counted."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    loop = load_module("loops", "zed_dense_replay")
    ev = lambda name, a, b, kernels=(), thread=1: NS(name=name, device_type=DeviceType.CPU, thread=thread,
                                                    time_range=NS(start=a, end=b), kernels=list(kernels))
    k = lambda name, us: NS(name=name, duration=us)
    prof = NS(events=lambda: [
        ev("ra.facade.feed_stereo", 0, 100), ev("ra.slam.detect", 10, 50, [k("graph_kernel", 300.0)]),
        ev("aten::add", 60, 70, [k("add_kernel", 20.0)]),
        ev("ra.stereo.dense", 200, 300), ev("aten::mul", 210, 220, [k("mul_kernel", 1000.0)]),
        ev("aten::copy_", 230, 240, [k("Memcpy DtoH (Device -> Pageable)", 5.0)]),
        ev("aten::mul", 250, 260, [k("mul_kernel", 7.0)], thread=2),  # another thread's
        ev("ra.stereo.dense", 400, 500), ev("aten::sub", 410, 420, [k("sub_kernel", 1000.0)]),
        ev("ra.facade.upload", 600, 700), ev("aten::to", 610, 620, [k("Memcpy HtoD (Pageable -> Device)", 9.0)]),
    ])
    out = loop._device_by_span(prof)
    assert out["ra.stereo.dense"] == {"calls": 2, "device_s": pytest.approx(2005e-6)}
    assert out["ra.slam.detect"] == {"calls": 1, "device_s": pytest.approx(300e-6)}
    assert out["ra.facade.feed_stereo"]["device_s"] == pytest.approx(320e-6)
    assert out["ra.seg.segment"] == {"calls": 0, "device_s": 0.0} and out["d2h"] == 1


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_control_is_not_correct(seed):
    cell = small_zed_cell()
    nums = calibrate.control_numbers(cell, seed, 6, torch.device("cpu"))
    ok, table = judge(nums, cell.limits)
    assert not ok, table
    lim = cell.limits
    assert nums["frame_rect"] > lim["frame_rect"] and nums["pose_at_stamp"] > lim["pose_at_stamp"]
    assert nums["dense_valid"] > lim["dense_valid"] and nums["map_tsdf"] > lim["map_tsdf"]


def _wrap_dense(monkeypatch, change):
    import ra_slam_tpu_torch.features.stereo as stereo

    real = stereo.dense_stereo_depth
    def wrapped(*a, **k):
        a, k = change(a, k)
        return real(*a, **k)

    monkeypatch.setattr(stereo, "dense_stereo_depth", wrapped)


def _fault_views_swapped(monkeypatch):
    _wrap_dense(monkeypatch, lambda a, k: ((a[1], a[0]) + a[2:], k))


def _fault_lr_check_skipped(monkeypatch):
    import ra_slam_tpu_torch.features.stereo as stereo

    monkeypatch.setattr(stereo, "_left_right_ok", lambda agg, u, d, best: torch.ones_like(best, dtype=torch.bool))


def _fault_half_range(monkeypatch):
    _wrap_dense(monkeypatch, lambda a, k: (a, dict(k, max_disparity=k["max_disparity"] // 2)))


def _fault_previous_pose(monkeypatch):
    import ra_slam_tpu_torch.pipeline.system as system

    real = system.RaSlamSystem._feed_rgbd
    previous = {}

    def feed(self, rgb, depth, timestamp, pose, ht, lt):
        q = self.slam.query_pose(previous.get(id(self), timestamp)) if pose is None and not self.slam.lost else None
        previous[id(self)] = timestamp
        return real(self, rgb, depth, timestamp, q, ht, lt)

    monkeypatch.setattr(system.RaSlamSystem, "_feed_rgbd", feed)


def _fault_rect_row_off(monkeypatch):
    from ra_slam_tpu_torch.core.rectify import StereoRectifier

    real = StereoRectifier.rectify
    calls = [0]

    def rectify(self, left, right):
        left, right = real(self, left, right)
        calls[0] += 1
        return (torch.roll(left, 1, 0) if calls[0] % 3 == 0 else left), right

    monkeypatch.setattr(StereoRectifier, "rectify", rectify)


@pytest.mark.parametrize("plant", [_fault_views_swapped, _fault_lr_check_skipped, _fault_half_range,
                                   _fault_previous_pose, _fault_rect_row_off],
                         ids=["views_swapped", "lr_check_skipped", "half_range", "previous_pose", "rect_row_off"])
def test_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    res = _run()
    assert not res["correct"], res["check"]
