"""The application facade of the PyTorch port
(ra_slam_tpu_torch/pipeline/system.py) with tracking on, against the JAX
package's on the CPU: frames tracked by `feed_tracking_frame` and fused
by `feed_rgbd_frame(pose=None)` at the tracked pose of their timestamp.
The map is tests/torch_parity.py's small configuration."""

import dataclasses

import jax
import numpy as np
import pytest

import torch_parity as tp
from ra_slam_tpu.core import config as jcfg
from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.pipeline.system import RaSlamSystem as JaxSystem
from ra_slam_tpu_torch.core import config as tcfg
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy

# the facade's tracking camera at tests/torch_parity.py's size: the
# default tracking gates (rescaled by the facade to 160 px), 300
# keypoints on 2 levels, and a depth camera 2 cm beside it
FACADE_FEAT = dict(max_num_keypoints=300, num_levels=2)
EXTRINSICS = [1.0, 0.0, 0.0, 0.02, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
FACADE_FRAMES = 3
FACADE_POSE_TOL = 1e-5  # tracked poses; measured <= 5.5e-8


def _facade_cfg(cfg_mod, tsdf_cfg):
    c = tp.CAM_KW
    return cfg_mod.SystemConfig(
        camera=cfg_mod.CameraConfig(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                                    height=c["height"]),
        tsdf=tsdf_cfg, feature=cfg_mod.FeatureConfig(**FACADE_FEAT), extrinsics=EXTRINSICS,
    )


def test_facade_tracking_and_fusion_match_jax():
    """Both facades, tracking on: each frame goes to feed_tracking_frame,
    then to feed_rgbd_frame(pose=None), which fuses it at the buffered
    tracked pose carried through the extrinsics. The same tracked and
    fused frames and counts, the queried poses within the bound, and the
    maps alike (tests/torch_parity.py's bounds). The JAX side runs op by
    op."""
    ds = SyntheticBoxDataset(num_frames=120, cam=SyntheticCameraSpec(**tp.CAM_KW), radius=1.0, seed=0)
    js = JaxSystem(_facade_cfg(jcfg, tp.jax_cfg()), enable_tracking=True)
    ts = RaSlamSystem(_facade_cfg(tcfg, tp.torch_cfg()), "cpu", enable_tracking=True)
    assert dataclasses.asdict(ts.slam.tcfg) == dataclasses.asdict(js.slam.tcfg)  # default gates, rescaled alike
    assert ts.slam.params.loop_max_rmse == js.slam.params.loop_max_rmse == 1.5
    with jax.disable_jit():
        for i in range(FACADE_FRAMES):
            fr = ds.frame(i)
            ji = js.feed_tracking_frame(fr.rgb, fr.depth, fr.timestamp)
            ti = ts.feed_tracking_frame(fr.rgb, fr.depth, fr.timestamp)
            for name in ("tracked", "num_matches", "num_inliers", "inserted_keyframe"):
                assert getattr(ti, name) == getattr(ji, name), (i, name)
            jq, tq = js.query_camera_pose(fr.timestamp), ts.query_camera_pose(fr.timestamp)
            np.testing.assert_allclose(tq.R.numpy(), np.asarray(jq.R), atol=FACADE_POSE_TOL)
            np.testing.assert_allclose(tq.t.numpy(), np.asarray(jq.t), atol=FACADE_POSE_TOL)
            jr = js.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, ht=fr.ht, lt=fr.lt)
            tr = ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, ht=fr.ht, lt=fr.lt)
            assert tr == jr, i
    assert ts.num_integrated == js.num_integrated == FACADE_FRAMES
    jm = jax.tree.map(np.asarray, js.map)
    tm = voxel_map_to_numpy(ts.map)
    for name in tp.EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)), getattr(tm, name), err_msg=name)
    for name, bound in tp.TOL.items():
        assert np.abs(np.asarray(getattr(jm, name)) - getattr(tm, name)).max() <= bound, name


def test_facade_skips_fusion_without_a_tracked_pose():
    """feed_rgbd_frame(pose=None) fuses nothing before the first tracked
    frame, and raises with tracking disabled."""
    ts = RaSlamSystem(_facade_cfg(tcfg, tp.torch_cfg()), "cpu", enable_tracking=True)
    fr = SyntheticBoxDataset(num_frames=120, cam=SyntheticCameraSpec(**tp.CAM_KW), radius=1.0).frame(0)
    assert ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, ht=fr.ht, lt=fr.lt) == {"skipped": "no pose"}
    assert ts.num_integrated == 0 and ts.query_camera_pose(fr.timestamp) is None
    off = RaSlamSystem(_facade_cfg(tcfg, tp.torch_cfg()), "cpu", enable_tracking=False)
    with pytest.raises(ValueError, match="no pose source"):
        off.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, ht=fr.ht, lt=fr.lt)
    with pytest.raises(RuntimeError, match="tracking disabled"):
        off.feed_tracking_frame(fr.rgb, fr.depth, fr.timestamp)
