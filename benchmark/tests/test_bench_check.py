"""`correct` holds the program to the reference: sound runs pass, and the
control and each fault that a fusion cell can have fail.

The runs here drive the whole of `run_cell` on the CPU at a small size
(the harness's look for a card is skipped; the program's nvjpeg decode,
which needs a card, is replaced by libjpeg's). The faults are planted
underneath the timed path:
- a step that returns its state unchanged: `integrate_frame` fuses
  nothing;
- half of the batch left out: half of the visible blocks are not fused;
- an answer altered where it is produced: one frame's fused tsdf is
  shifted.
One chip exchanges nothing, so the fault of a missing exchange has no
place here.
"""

from __future__ import annotations

import pytest
import torch

from small import ROOT, args, cv2_decode_jpeg, small_cell  # noqa: F401

from benchmark import calibrate, run
from benchmark.harness.spec import load_module
from benchmark.reference.compare import judge

CELL = "scannet_gt_seg"


@pytest.fixture
def cpu_jpeg(monkeypatch):
    import ra_slam_tpu_torch.io.jpeg as jpeg

    monkeypatch.setattr(jpeg, "decode_jpeg_numpy", cv2_decode_jpeg)


def _run(seed=5, seconds=0.6):
    res = run.run_cell(small_cell(CELL, 6), args(seed=seed, seconds=seconds), torch.device("cpu"), load_module)
    assert res is not None
    return res


def test_sound_run_is_correct(cpu_jpeg):
    res = _run()
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_control_is_not_correct(seed):
    cell = small_cell(CELL, 6)
    nums = calibrate.control_numbers(cell, seed, 6, torch.device("cpu"))
    ok, table = judge(nums, cell.limits)
    assert not ok, table


def _fault_unchanged(monkeypatch):
    import ra_slam_tpu_torch.pipeline.system as system

    def integrate_frame(m, *a, **k):
        z = torch.zeros((), dtype=torch.int32)
        return m, {"num_active": z, "num_visible": z, "alloc_failures": z}

    monkeypatch.setattr(system, "integrate_frame", integrate_frame)


def _fault_half_batch(monkeypatch):
    import ra_slam_tpu_torch.map.voxel_map as vm

    real = vm.integrate

    def integrate(m, vis_idx, vis_mask, *a, **k):
        half = vis_mask.clone()
        half[1::2] = False
        return real(m, vis_idx, half, *a, **k)

    monkeypatch.setattr(vm, "integrate", integrate)


def _fault_altered(monkeypatch):
    import ra_slam_tpu_torch.map.voxel_map as vm

    real = vm.tsdf_fuse_
    calls = {"n": 0}

    def fuse(m, vis_idx, vis_mask, *a, **k):
        out = real(m, vis_idx, vis_mask, *a, **k)
        calls["n"] += 1
        if calls["n"] >= 3:  # every frame of the window
            rows = vis_idx[vis_mask].long()
            m.tsdf[rows] = (m.tsdf[rows] + 0.05).clamp(max=1.0)
        return out

    monkeypatch.setattr(vm, "tsdf_fuse_", fuse)


@pytest.mark.parametrize("plant", [_fault_unchanged, _fault_half_batch, _fault_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(cpu_jpeg, monkeypatch, plant):
    plant(monkeypatch)
    res = _run()
    assert not res["correct"], res["check"]
