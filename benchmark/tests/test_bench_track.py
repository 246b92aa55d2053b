"""The tracking reference's numbers against hand-worked trajectories."""

from __future__ import annotations

import numpy as np
import pytest

from small import ROOT  # noqa: F401

from benchmark.harness import scene
from benchmark.reference import track


def _truth(n=20):
    return scene.walk(n, (1.0, 0.8), 0.1)


def _as_tracked(W, err=None, world=False):
    """cam_T_world in the first camera's frame, optionally perturbed in
    the camera's frame or (`world`) in the SLAM world's."""
    out = []
    for i in range(len(W)):
        Q = np.linalg.inv(W[0]) @ W[i]
        if err is not None:
            Q = err(i) @ Q if world else Q @ err(i)
        out.append(np.linalg.inv(Q))
    return np.stack(out)


def test_truth_reads_zero():
    W = _truth()
    nums = track.combine([track.pose_errors(_as_tracked(W), np.ones(len(W), bool), W)])
    assert all(v < 1e-9 for v in nums.values()), nums


def test_a_frame_offset_reads_as_its_size():
    W = _truth()

    def err(i):  # frame 10 alone 1 cm off along its x
        m = np.eye(4)
        if i == 10:
            m[0, 3] = 0.01
        return m

    e = track.pose_errors(_as_tracked(W, err), np.ones(len(W), bool), W)
    # two of the 19 pairs carry the 1 cm error
    assert np.isclose(np.sqrt(e["rpe_t2"].mean()), 0.01 * np.sqrt(2 / 19))
    assert np.isclose(np.sqrt(e["ate_anchored2"].mean()), 0.01 / np.sqrt(20))
    assert np.sqrt(e["ate2"].mean()) <= np.sqrt(e["ate_anchored2"].mean())


def test_rotation_error_in_degrees():
    W = _truth()
    a = np.radians(0.5)

    def err(i):  # the world turned 0.5 deg more at every frame: each step's error is a 0.5 deg turn
        m = np.eye(4)
        c, s = np.cos(a * i), np.sin(a * i)
        m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        return m

    nums = track.combine([track.pose_errors(_as_tracked(W, err, world=True), np.ones(len(W), bool), W)])
    assert nums["track_rpe_deg"] == pytest.approx(0.5, rel=1e-6)


def test_lost_frames_leave_their_pairs_out():
    W = _truth()
    ok = np.ones(len(W), bool)
    ok[5] = False
    e = track.pose_errors(_as_tracked(W), ok, W)
    assert e["rpe_t2"].size == 17 and e["ate2"].size == 19


def test_alignment_removes_a_rigid_motion():
    W = _truth()
    rng = np.random.default_rng(2)
    A = np.eye(4)
    A[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * np.sign(np.linalg.det(np.linalg.qr(rng.normal(size=(3, 3)))[0]))
    A[:3, :3] *= np.sign(np.linalg.det(A[:3, :3]))
    A[:3, 3] = [0.3, -0.2, 0.5]
    nums = track.combine([track.pose_errors(_as_tracked(W, lambda i: A, world=True), np.ones(len(W), bool), W)])
    assert nums["track_ate_m"] < 1e-9 and nums["track_ate_anchored_m"] > 0.1


def test_bf16_rounds_as_torch():
    import torch

    x = np.array([1.0, 0.1234567, -2.71828, 3.3333333, 1e-3])
    assert np.array_equal(track.bf16(x), torch.tensor(x).to(torch.bfloat16).double().numpy())
