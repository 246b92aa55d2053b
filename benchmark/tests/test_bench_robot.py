"""`correct` in the robot's replay (`zed_l515_dual_replay`) on the CPU, at
a small size (the ZED at a third of its size, the L515 at a quarter, 4
pyramid levels, 6 cycles): a sound run passes, and the control and each
fault that the cell can have fail. The reference it is held against
loads neither JAX nor the program.

Faults planted underneath the timed path:
- the depth camera ignored: the L515's frames fused with the tracking
  camera's intrinsics (the fault this cell was added for);
- the hand-off broken: the extrinsics dropped, or the pose buffer
  answering with the nearest pose instead of interpolating;
- the rectification skipped: the raw views tracked as they come;
- a step that returns its state unchanged: `integrate_frame` fuses
  nothing;
- half of the batch left out: tracking reports every other pair lost.
"""

from __future__ import annotations

import copy

import pytest
import torch

from small import ROOT, args

from benchmark import calibrate, run
from benchmark.harness.spec import load_cell, load_module
from benchmark.reference import rig
from benchmark.reference.compare import judge
from test_bench_imports import FORBIDDEN, _top_level_after

CELL = "zed_l515_dual_replay"


def small_robot_cell(cycles: int = 6):
    cell = copy.deepcopy(load_cell(CELL, ROOT))
    c, t = cell.config, cell.traffic
    z = c["zed"]
    sx, sy = 224 / z["width"], 128 / z["height"]
    for side in ("left", "right"):
        cam = z["calibration"][side]
        cam.update(fx=cam["fx"] * sx, fy=cam["fy"] * sy, cx=(cam["cx"] + 0.5) * sx - 0.5,
                   cy=(cam["cy"] + 0.5) * sy - 0.5)
    z.update(width=224, height=128)
    l5 = c["l515"]
    l5.update(fx=l5["fx"] / 4, fy=l5["fy"] / 4, cx=(l5["cx"] + 0.5) / 4 - 0.5, cy=(l5["cy"] + 0.5) / 4 - 0.5,
              width=320, height=180)
    c["map"].update(voxel_size=0.04, truncation=0.24, log2_num_blocks=14, log2_hash_size=16,
                    max_visible_blocks=4096, max_new_blocks=4096, width=160, height=90)
    c["depth_camera"].update(fx=l5["fx"] / 2, fy=l5["fy"] / 2, cx=l5["cx"] / 2, cy=l5["cy"] / 2, width=160, height=90)
    c["tracking"].update(max_num_keypoints=300, num_levels=4)
    c["room"]["clutter"] = 3
    t.update(zed_pairs=2 * cycles, l515_frames=cycles, warmup_cycles=2, trace_after_cycles=1, trace_cycles=2,
             check_rect_pairs=2)
    return cell


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads a test: the tests share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _run(seed=2**31 + 7, seconds=8.0):
    res = run.run_cell(small_robot_cell(), args(seed=seed, seconds=seconds), torch.device("cpu"), load_module)
    assert res is not None
    return res


def test_the_reference_loads_neither_jax_nor_the_program():
    mods = _top_level_after("import benchmark.reference.rig")
    assert "torch" in mods and not mods & (FORBIDDEN | {"ra_slam_tpu_torch"})


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["check"]
    c = res["counters"]
    assert res["failed"] == 0 and c["frames_fused"] >= 1
    assert c["rectify.calls"] == c["zed_calls"] and c["pose_buffer.interpolated"] == c["frames_fused"]


@pytest.mark.parametrize("cell", [load_cell(CELL, ROOT), small_robot_cell()], ids=["shipped", "small"])
def test_depth_camera_is_the_l515_at_the_maps_size(cell):
    """The configuration's `depth_camera`, which the fused frame's readers
    read, is the L515 as the facade fuses it (its `tsdf_cam`)."""
    c = cell.config
    d, size = c["depth_camera"], (c["map"]["width"], c["map"]["height"])
    assert (d["width"], d["height"]) == size
    assert [d[k] for k in ("fx", "fy", "cx", "cy")] == pytest.approx(rig.scaled_intrinsics(c["l515"], size), abs=1e-6)


def test_traced_run_counts_the_fusion_work(tmp_path):
    """`--trace 1` counts the fused frames of the profiled cycles and the
    fusion's work of each, which `mfu.fuse` and `fuse_roofline` read."""
    cell = small_robot_cell()
    cell.traffic.update(trace_after_cycles=0, trace_cycles=1)  # the profiler slows a CPU cycle to seconds
    out = load_module("loops", cell.traffic["loop"]).run(
        run.Context(cell, 2**31 + 7, 20.0, True, torch.device("cpu"), tmp_path))
    c = out["counters"]
    assert c["traced_fused"] >= 1 and len(c["traced_work"]) == c["traced_fused"]
    assert all(v > 0 and u > 0 for v, u in c["traced_work"])
    assert load_module("metrics", "mfu.fuse").read(out, cell) > 0


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_control_is_not_correct(seed):
    cell = small_robot_cell()
    nums = calibrate.control_numbers(cell, seed, 6, torch.device("cpu"))
    ok, table = judge(nums, cell.limits)
    assert not ok, table
    assert nums["frame_rect"] > cell.limits["frame_rect"] and nums["pose_handoff"] > cell.limits["pose_handoff"]


def _after_init(monkeypatch, change):
    import ra_slam_tpu_torch.pipeline.system as system

    init = system.RaSlamSystem.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)
        change(self)

    monkeypatch.setattr(system.RaSlamSystem, "__init__", patched)


def _fault_depth_camera_ignored(monkeypatch):
    from ra_slam_tpu_torch.core.camera import PinholeCamera

    def change(s):
        c = s.cfg.camera
        s.tsdf_cam = PinholeCamera.create(c.fx, c.fy, c.cx, c.cy, c.width, c.height).resized(
            s.cfg.tsdf.width, s.cfg.tsdf.height)

    _after_init(monkeypatch, change)


def _fault_extrinsics_dropped(monkeypatch):
    _after_init(monkeypatch, lambda s: setattr(s, "extrinsics", None))


def _fault_nearest_pose(monkeypatch):
    from ra_slam_tpu_torch.utils.pose_buffer import PoseBuffer

    def query(self, timestamp):
        entries = self.entries()
        return min(entries, key=lambda e: abs(e[0] - timestamp))[1] if entries else None

    monkeypatch.setattr(PoseBuffer, "query", query)


def _fault_rectify_skipped(monkeypatch):
    from ra_slam_tpu_torch.core.rectify import StereoRectifier

    monkeypatch.setattr(StereoRectifier, "rectify", lambda self, l, r: (l.copy(), r.copy()))


def _fault_unchanged(monkeypatch):
    import ra_slam_tpu_torch.pipeline.system as system

    def integrate_frame(m, *a, **k):
        z = torch.zeros((), dtype=torch.int32)
        return m, {"num_active": z, "num_visible": z, "alloc_failures": z}

    monkeypatch.setattr(system, "integrate_frame", integrate_frame)


def _fault_half_lost(monkeypatch):
    from ra_slam_tpu_torch.slam.system import FrameInfo

    real = FrameInfo.__getattr__
    calls = {"n": 0}

    def getattr_(self, name):
        v = real(self, name)
        if name == "tracked":
            calls["n"] += 1
            return v and calls["n"] % 2 == 0
        return v

    monkeypatch.setattr(FrameInfo, "__getattr__", getattr_)


@pytest.mark.parametrize("plant", [_fault_depth_camera_ignored, _fault_extrinsics_dropped, _fault_nearest_pose,
                                   _fault_rectify_skipped, _fault_unchanged, _fault_half_lost],
                         ids=["depth_camera_ignored", "extrinsics_dropped", "nearest_pose", "rectify_skipped",
                              "state_unchanged", "half_lost"])
def test_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    res = _run()
    assert not res["correct"], res["check"]
