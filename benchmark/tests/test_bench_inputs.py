"""The generators are deterministic per seed, and the `.sens` writer
round-trips through the reference's reader."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from small import ROOT, small_cell  # noqa: F401

from benchmark.harness import inputs, scene, weights
from benchmark.reference.sens import Sens

SEEDS = [0, 7, 2**31 + 12345, 4_000_000_001]


def test_room_and_walk_are_the_same_for_every_seed():
    r1, r2 = scene.make_room((3.0, 1.5, 2.5), 5), scene.make_room((3.0, 1.5, 2.5), 5)
    assert np.array_equal(r1.box_lo, r2.box_lo) and np.array_equal(r1.box_color, r2.box_color)
    w = scene.walk(40, (1.2, 0.8), 0.1)
    assert np.array_equal(w, scene.walk(40, (1.2, 0.8), 0.1))
    steps = np.linalg.norm(np.diff(w[:, :3, 3], axis=0), axis=1)
    assert 0.005 < steps.mean() < 0.3  # a walk, not a jump


@pytest.mark.parametrize("seed", SEEDS)
def test_sequence_repeats_per_seed(tmp_path, seed):
    cell = small_cell("scannet_gt_seg", frames=2)
    a = inputs.make_rgbd_sequence(cell.config, cell.traffic, seed, "cpu", str(tmp_path / "a.sens"))
    b = inputs.make_rgbd_sequence(cell.config, cell.traffic, seed, "cpu", str(tmp_path / "b.sens"))
    c = inputs.make_rgbd_sequence(cell.config, cell.traffic, seed + 1, "cpu", str(tmp_path / "c.sens"))
    assert (tmp_path / "a.sens").read_bytes() == (tmp_path / "b.sens").read_bytes()
    assert Sens(a.path).depth(1).tolist() != Sens(c.path).depth(1).tolist()  # the noise is the seed's


def test_render_repeats_and_sees_the_room():
    room = scene.make_room((3.0, 1.5, 2.5), 4)
    poses = torch.as_tensor(scene.walk(4, (1.2, 0.8), 0.1), dtype=torch.float64)
    a = scene.render(room, poses, 40.0, 40.0, 31.5, 23.5, 64, 48)
    b = scene.render(room, poses, 40.0, 40.0, 31.5, 23.5, 64, 48)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float(a[1].min()) > 0.3 and float(a[1].max()) < 8.0


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_weights_repeat_per_seed(seed):
    w1 = weights.make_weights((32, 64, 128, 256), seed, "cpu")
    w2 = weights.make_weights((32, 64, 128, 256), seed, "cpu")
    w3 = weights.make_weights((32, 64, 128, 256), seed + 1, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["ConvBlock_0/Conv_0/kernel"], w3["ConvBlock_0/Conv_0/kernel"])


def test_checkpoint_loads_into_the_program():
    from ra_slam_tpu_torch.models.segmentation import SegmentationNet
    from ra_slam_tpu_torch.utils.convert import seg_state_dict_from_flax
    from ra_slam_tpu_torch.utils.flax_msgpack import unpackb

    w = weights.make_weights((32, 64, 128, 256), 5, "cpu")
    net = SegmentationNet()
    sd = seg_state_dict_from_flax(unpackb(weights.checkpoint_bytes(w)), net)
    net.load_state_dict(sd)
    assert torch.equal(sd["head.weight"], w["Conv_3/kernel"].permute(3, 2, 0, 1))


def test_sens_round_trip(tmp_path):
    cell = small_cell("scannet_gt_seg", frames=5)
    seq = inputs.make_rgbd_sequence(cell.config, cell.traffic, 11, "cpu", str(tmp_path / "a.sens"))
    seq2 = inputs.make_rgbd_sequence(cell.config, cell.traffic, 11, "cpu", str(tmp_path / "b.sens"))
    assert (tmp_path / "a.sens").read_bytes() == (tmp_path / "b.sens").read_bytes()
    ref = Sens(seq.path)
    cfg = cell.config
    assert len(ref) == 5 and (ref.depth_w, ref.depth_h) == (cfg["depth_camera"]["width"], cfg["depth_camera"]["height"])
    assert (ref.color_w, ref.color_h) == (cfg["color"]["width"], cfg["color"]["height"])
    for j in range(5):
        want = np.linalg.inv(seq.world_T_cam[j].astype(np.float32).astype(np.float64))
        assert np.allclose(ref.pose(j), want, atol=1e-6)
        d = ref.depth(j)
        assert d.dtype == np.float32 and 0.3 < d[d > 0].min() and d.max() < 8.0
        assert ref.color(j).shape == (ref.depth_h, ref.depth_w, 3)
    assert seq2.bytes_written == seq.bytes_written


def test_program_reader_agrees_with_the_reference(tmp_path, monkeypatch):
    """The program's SensReader and the reference's give the same depth
    and pose, and colour within a level where both decode with libjpeg."""
    from small import cv2_decode_jpeg
    import ra_slam_tpu_torch.io.jpeg as jpeg
    from ra_slam_tpu_torch.io.sens import SensReader

    monkeypatch.setattr(jpeg, "decode_jpeg_numpy", cv2_decode_jpeg)
    cell = small_cell("scannet_gt_seg", frames=3)
    seq = inputs.make_rgbd_sequence(cell.config, cell.traffic, 4, "cpu", str(tmp_path / "a.sens"))
    prog, ref = SensReader(seq.path), Sens(seq.path)
    try:
        for j in range(3):
            f = prog.frame(j)
            assert np.array_equal(f.depth, ref.depth(j)) and np.array_equal(f.cam_T_world, ref.pose(j))
            assert np.abs(f.rgb.astype(int) - ref.color(j).astype(int)).max() <= 1
    finally:
        prog.close()
