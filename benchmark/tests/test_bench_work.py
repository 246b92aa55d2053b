"""The yardstick's counts against hand-worked values at small shapes."""

from __future__ import annotations

from small import ROOT, small_cell  # noqa: F401

from benchmark.harness import inputs
from benchmark.harness.work import fuse_bytes, unet_flops
from benchmark.loops import rgbd_replay


def test_fuse_bytes_hand_worked():
    # 2 visible blocks: every voxel's tsdf read, 2 * 512 * 4 B = 4096 B;
    # 100 updated voxels: weight, prob, rgb read (20 B) and all 24 B
    # written, 100 * 44 = 4400 B; a 4 x 2 frame's six float32 planes read
    # once: 6 * 4 * 8 = 192 B
    assert fuse_bytes(2, 100, 2, 4) == 4096 + 4400 + 192 == 8688
    assert fuse_bytes(0, 0, 480, 640) == 24 * 480 * 640
    # every voxel updated: the whole payload read and written once
    assert fuse_bytes(3, 3 * 512, 2, 4) == 3 * 512 * 24 * 2 + 192


def test_fusion_work_counts_the_updated_voxels(tmp_path):
    """The reference's count of a frame's work: some, not all, of the
    visible voxels update, and a frame counts the same whichever frames
    are asked for beside it (each replay starts from the session's
    start)."""
    cell = small_cell("scannet_gt_seg", frames=4)
    seq = inputs.make_rgbd_sequence(cell.config, cell.traffic, 6, "cpu", str(tmp_path / "a.sens"))
    work = rgbd_replay.fusion_work(cell.config, "cpu", seq.path, [1, 3])
    assert len(work) == 2
    assert all(v > 0 and 0 < u < v * 512 for v, u in work)
    assert rgbd_replay.fusion_work(cell.config, "cpu", seq.path, [3]) == work[1:]


def test_unet_flops_hand_worked():
    # widths (2, 4) at 4 x 4, 2 classes:
    #   level 0 block: 16 px * 9 * (3*2 + 2*2) = 1440 MACs
    #   bottleneck at 2 x 2: 4 * 9 * (2*4 + 4*4) = 864
    #   decoder level 0: upsampling conv 16 * 9 * (4*2) = 1152,
    #                    block 16 * 9 * (4*2 + 2*2) = 1728
    #   logits: 16 * 2 * 2 = 64
    assert unet_flops((2, 4), 4, 4) == 2 * (1440 + 864 + 1152 + 1728 + 64)


def test_unet_flops_matches_the_programs_count():
    """The program counts its UNet the same way (it is not the yardstick,
    only a second witness at the served size)."""
    from ra_slam_tpu_torch.models.segmentation import forward_flops

    for widths, h, w in [((32, 64, 128, 256), 480, 640), ((8, 16), 64, 96)]:
        assert unet_flops(widths, h, w) == forward_flops(widths, h, w)
