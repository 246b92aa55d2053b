"""`correct` in the tracked replay (`scannet_slam_seg`): a sound run
passes, and each fault that the cell can have fails. Tracking takes
seconds a frame on the CPU, so these run on the card (marked `cuda`;
they skip where there is none), at the cell's own sizes with a short
window.

Faults planted underneath the timed path:
- a step that returns its state unchanged: tracking (`slam_frame_step`
  hands back the state and the answer of the session's first frame) and
  fusion (`integrate_frame` fuses nothing);
- half of the batch left out: half of the visible blocks are not fused;
  tracking reports every other frame lost (the rest pass every other
  number; `track_lost` catches it);
- an answer altered where it is produced: each tracked pose moved by
  10 cm, in turns one way and the other; each frame's fused tsdf
  shifted.
One chip exchanges nothing, so the fault of a missing exchange has no
place here.
"""

from __future__ import annotations

import pytest
import torch

from small import ROOT, args  # noqa: F401

from benchmark import run
from benchmark.harness.spec import load_cell, load_module
from test_bench_check import _fault_altered, _fault_half_batch, _fault_unchanged

pytestmark = pytest.mark.cuda
CELL = "scannet_slam_seg"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the tracked replay's check runs on a CUDA card (seconds a frame on the CPU)")
    return torch.device("cuda:0")


def _run(device, seconds=8.0, seed=3300000001):
    res = run.run_cell(load_cell(CELL, ROOT), args(seed=seed, seconds=seconds), device, load_module)
    assert res is not None
    return res


def test_sound_run_is_correct(card):
    res = _run(card)
    assert res["correct"], res["check"]


def _track_unchanged(monkeypatch):
    import ra_slam_tpu_torch.slam.system as slam

    real, first = slam.slam_frame_step, {}

    def step(state, *a, **k):
        if "out" not in first or int(a[2]) == 0:  # a new session's first frame (its id is 0)
            first["out"] = real(state, *a, **k)
            return first["out"]
        return state, first["out"][1]

    monkeypatch.setattr(slam, "slam_frame_step", step)


def _track_altered(monkeypatch):
    import ra_slam_tpu_torch.slam.system as slam

    real, n = slam.slam_frame_step, {"k": 0}

    def step(*a, **k):
        state, info = real(*a, **k)
        n["k"] += 1
        shift = torch.tensor([0.1 if n["k"] % 2 else -0.1, 0.0, 0.0], device=info._t.device)
        return state, slam.FrameInfo(info._R, info._t + shift, **info._dev)

    monkeypatch.setattr(slam, "slam_frame_step", step)


def _track_half_lost(monkeypatch):
    import ra_slam_tpu_torch.slam.system as slam

    real, n = slam.slam_frame_step, {"k": 0}

    def step(*a, **k):
        state, info = real(*a, **k)
        n["k"] += 1
        if n["k"] % 2:
            return state, info
        lost = dict(info._dev, tracked=torch.zeros_like(info._dev["tracked"]))
        return state, slam.FrameInfo(info._R, info._t, **lost)

    monkeypatch.setattr(slam, "slam_frame_step", step)


@pytest.mark.parametrize("plant", [_track_unchanged, _track_altered, _track_half_lost, _fault_unchanged,
                                   _fault_half_batch, _fault_altered],
                         ids=["track_unchanged", "track_altered", "track_half_lost", "fuse_unchanged",
                              "fuse_half_batch", "fuse_altered"])
def test_fault_is_not_correct(card, monkeypatch, plant):
    plant(monkeypatch)
    res = _run(card)
    assert not res["correct"], res["check"]
