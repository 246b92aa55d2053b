"""`SlamSystem.refine_map(mesh=...)` of the PyTorch port, the production
call site of the distributed Schur solver, against the JAX package's on
tests/test_dist_ba.py's call site: the port tracks the first 10 frames
of the 160x120 orbit, the JAX system takes its state, and both refine
the whole map over a 2-shard mesh (a 2-device `jax.sharding.Mesh`, its
solver jitted as the JAX package runs it; `LocalMesh(2)`)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from ra_slam_tpu.core.config import FeatureConfig as JaxFeatureConfig
from ra_slam_tpu.core.config import TrackingConfig as JaxTrackingConfig
from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.slam.system import SlamSystem as JaxSlamSystem
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import FeatureConfig, TrackingConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.parallel import LocalMesh
from ra_slam_tpu_torch.slam.system import SlamSystem
from ra_slam_tpu_torch.utils.convert import slam_state_to_numpy

FEAT_KW = dict(max_num_keypoints=300, num_levels=3)
TRACK_KW = dict(min_inliers=12, match_radius=30.0)
SLAM_KW = dict(ba_window=4, ba_max_points=1024, ba_iterations=3)
REFINE_KW = dict(window=4, iterations=3, sweeps=1)
# float32 Schur solves from identical inputs, summed in other orders
# (and XLA's jitted multiply-adds): measured 1.2e-7 px on the rmse,
# 7.1e-8 on keyframe poses and 4.8e-7 on landmark positions
RMSE_TOL, POSE_TOL, POINT_TOL = 1e-4, 2e-5, 5e-5


def _to_jax(template, arrays):
    """The port's state in the JAX layout (numpy leaves) as the JAX
    package's state type, shaped like `template`."""
    if hasattr(template, "_fields"):
        return type(template)(*[_to_jax(getattr(template, f), getattr(arrays, f)) for f in template._fields])
    return jnp.asarray(arrays, dtype=template.dtype)


def test_refine_map_over_a_mesh_matches_jax():
    spec = SyntheticCameraSpec(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120)
    ds = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, seed=0)
    c = ds.camera
    ts = SlamSystem(PinholeCamera.create(float(c.fx), float(c.fy), float(c.cx), float(c.cy), c.width, c.height),
                    fcfg=FeatureConfig(**FEAT_KW), tcfg=TrackingConfig(**TRACK_KW), device="cpu", **SLAM_KW)
    for i in range(10):
        fr = ds.frame(i)
        hint = SE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
        assert ts.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=hint).tracked
    kfc = int(ts.state.track.kf_counter)
    assert kfc >= 2
    state = slam_state_to_numpy(ts.state)
    js = JaxSlamSystem(ds.camera, fcfg=JaxFeatureConfig(**FEAT_KW), tcfg=JaxTrackingConfig(**TRACK_KW), **SLAM_KW)
    js.state = _to_jax(js.state, state)

    jr = js.refine_map(mesh=Mesh(np.array(jax.devices()[:2]), ("ba",)), **REFINE_KW)
    tr = ts.refine_map(mesh=LocalMesh(2, "cpu", axis="ba"), **REFINE_KW)
    assert tr["windows"] == jr["windows"] >= 1
    for name in ("rmse_before", "rmse_after"):
        np.testing.assert_allclose(tr[name], jr[name], atol=RMSE_TOL)
    np.testing.assert_allclose(ts.state.kfs.R.numpy(), np.asarray(js.state.kfs.R), atol=POSE_TOL)
    np.testing.assert_allclose(ts.state.kfs.t.numpy(), np.asarray(js.state.kfs.t), atol=POSE_TOL)
    np.testing.assert_allclose(ts.state.track.lms.pos.numpy(), np.asarray(js.state.track.lms.pos), atol=POINT_TOL)
    # tests/test_dist_ba.py's gates: finite, converged, poses within 2 cm
    assert np.isfinite(tr["rmse_after"]) and tr["rmse_after"] <= tr["rmse_before"] + 0.5
    assert float(np.abs(ts.state.kfs.t[:kfc].numpy() - state.kfs.t[:kfc]).max()) < 0.02
