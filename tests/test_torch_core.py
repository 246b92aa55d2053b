"""SE3, pinhole camera and config of the PyTorch port against the JAX
package (ra_slam_tpu_torch/core/), bit for bit on the same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ra_slam_tpu.core import config as jconfig
from ra_slam_tpu.core.camera import PinholeCamera as JaxCamera
from ra_slam_tpu.core.se3 import SE3 as JaxSE3, exp_so3
from ra_slam_tpu_torch.core import config as tconfig
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.se3 import SE3


def _pose(seed):
    rng = np.random.default_rng(seed)
    R = np.asarray(exp_so3(jnp.asarray(rng.normal(size=3), jnp.float32)))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = R
    m[:3, 3] = rng.uniform(-2, 2, 3)
    return m


def test_se3_apply_inverse_exact():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (7, 9, 4, 3)).astype(np.float32)
    m = _pose(1)
    jT = JaxSE3.from_matrix(jnp.asarray(m))
    tT = SE3.from_matrix(torch.from_numpy(m))
    np.testing.assert_array_equal(np.asarray(jT.apply(pts)), tT.apply(torch.from_numpy(pts)).numpy())
    ji, ti = jT.inverse(), tT.inverse()
    np.testing.assert_array_equal(np.asarray(ji.as_matrix()), ti.as_matrix().numpy())
    np.testing.assert_array_equal(np.asarray(ji.apply(pts)), ti.apply(torch.from_numpy(pts)).numpy())


def test_camera_project_unproject_exact():
    rng = np.random.default_rng(2)
    jc = JaxCamera.create(320.0, 321.5, 319.5, 239.5, 640, 480, scale=0.5)
    tc = PinholeCamera.create(320.0, 321.5, 319.5, 239.5, 640, 480, scale=0.5)
    assert (tc.width, tc.height) == (jc.width, jc.height)
    assert [tc.fx, tc.fy, tc.cx, tc.cy] == [float(jc.fx), float(jc.fy), float(jc.cx), float(jc.cy)]
    pts = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    pts[:50, 2] = 0.0  # the |z| < 1e-9 guard
    (uvj, zj), (uvt, zt) = jc.project(jnp.asarray(pts)), tc.project(torch.from_numpy(pts))
    np.testing.assert_array_equal(np.asarray(uvj), uvt.numpy())
    np.testing.assert_array_equal(np.asarray(zj), zt.numpy())
    uv = rng.uniform(0, 320, (5000, 2)).astype(np.float32)
    d = rng.uniform(0.1, 6, 5000).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jc.unproject(jnp.asarray(uv), jnp.asarray(d))),
        tc.unproject(torch.from_numpy(uv), torch.from_numpy(d)).numpy(),
    )
    jr, tr = jc.resized(200, 150), tc.resized(200, 150)
    assert [tr.fx, tr.fy, tr.cx, tr.cy] == [float(jr.fx), float(jr.fy), float(jr.cx), float(jr.cy)]


def test_config_defaults_match():
    for name in ("CameraConfig", "TsdfConfig"):
        j = dataclasses.asdict(getattr(jconfig, name)())
        t = dataclasses.asdict(getattr(tconfig, name)())
        assert j == t, name
    assert tconfig.TsdfConfig().num_blocks == jconfig.TsdfConfig().num_blocks


_YAML = {
    # the reference's flat keys
    "flat": "Camera.fx: 615.5\nCamera.fy: 616.0\nCamera.cx: 318.2\nCamera.cy: 241.7\n"
            "Camera.cols: 848\nCamera.rows: 480\nCamera.fps: 15\ndepthmap_factor: 1000\n"
            "tsdf.width: 424\ntsdf.height: 240\n",
    # nested keys, extrinsics included
    "nested": "camera: {fx: 500, cy: 200, width: 320, height: 240, focal_x_baseline: 40.5}\n"
              "tsdf: {voxel_size: 0.02, truncation: 0.1, log2_num_blocks: 14, max_depth: 4}\n"
              "Extrinsics: [1, 0, 0, 0.1, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]\n",
}


@pytest.mark.parametrize("style", sorted(_YAML))
def test_load_yaml_config_matches(style, tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(_YAML[style])
    j, t = jconfig.load_yaml_config(str(path)), tconfig.load_yaml_config(str(path))
    assert dataclasses.asdict(t.camera) == dataclasses.asdict(j.camera)
    assert dataclasses.asdict(t.tsdf) == dataclasses.asdict(j.tsdf)
    assert t.extrinsics == j.extrinsics
