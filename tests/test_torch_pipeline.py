"""The known-pose CLI of the PyTorch port
(ra_slam_tpu_torch/pipeline/offline_eval.py) against the JAX package's,
on the CPU, and the port's import boundary (tests/test_torch_facade.py
holds the facade's tracked fusion against JAX)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.pipeline import offline_eval as jax_cli
from ra_slam_tpu.pipeline.system import RaSlamSystem as JaxSystem
from ra_slam_tpu_torch.io import synthetic as tsyn
from ra_slam_tpu_torch.pipeline import offline_eval as port_cli

# the fast-tier arguments of tests/test_pipeline.py's CLI test
ARGS = ["--synthetic", "--max-frames", "3", "--voxel-size", "0.05",
        "--truncation", "0.3", "--log2-blocks", "13"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_offline_eval_matches_jax(tmp_path, monkeypatch):
    """Same counts as the JAX CLI, and a tsdf.bin with byte-equal xyz and
    tsdf/prob within the bounds. The JAX CLI runs op by op (see
    tests/torch_parity.py); its mesh dump is not ported and is skipped."""
    monkeypatch.setattr(JaxSystem, "download_all_mesh", lambda self, *paths: (0, 0))
    with jax.disable_jit():
        rj = jax_cli.main(ARGS + ["--download", str(tmp_path / "jax")])
    rt = port_cli.main(ARGS + ["--download", str(tmp_path / "port"), "--device", "cpu"])
    for key in ("frames", "num_active", "num_visible", "alloc_failures", "tsdf_rows"):
        assert rt[key] == rj[key], key
    assert rt["frames"] == 3 and rt["tsdf_rows"] > 0
    a = np.fromfile(tmp_path / "jax" / "tsdf.bin", "<f4").reshape(-1, 5)
    b = np.fromfile(tmp_path / "port" / "tsdf.bin", "<f4").reshape(-1, 5)
    assert a[:, :3].tobytes() == b[:, :3].tobytes()
    assert np.abs(a[:, 3] - b[:, 3]).max() <= tp.TOL["tsdf"]
    assert np.abs(a[:, 4] - b[:, 4]).max() <= tp.TOL["prob"]


def test_synthetic_frames_match_jax():
    """The port's numpy copy of the synthetic dataset renders the JAX
    package's frames exactly."""
    kw = dict(num_frames=20, radius=1.0, clutter=3, depth_noise=0.01, seed=4)
    jds = SyntheticBoxDataset(cam=SyntheticCameraSpec(**tp.CAM_KW), **kw)
    tds = tsyn.SyntheticBoxDataset(cam=tsyn.SyntheticCameraSpec(**tp.CAM_KW), **kw)
    jc, tc = jds.camera, tds.camera
    assert [tc.fx, tc.fy, tc.cx, tc.cy, tc.width, tc.height] == [
        float(jc.fx), float(jc.fy), float(jc.cx), float(jc.cy), jc.width, jc.height]
    for i in (0, 7, 13):
        fj, ft = jds.frame(i), tds.frame(i)
        for name in ("rgb", "depth", "cam_T_world", "ht", "lt"):
            np.testing.assert_array_equal(getattr(fj, name), getattr(ft, name), err_msg=name)


_GUARD = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "yaml", "cv2"):
    sys.modules[name] = None  # any import of them raises ImportError
import ra_slam_tpu_torch
from ra_slam_tpu_torch.pipeline import offline_eval
r = offline_eval.main(["--synthetic", "--max-frames", "1", "--voxel-size", "0.05",
                       "--truncation", "0.3", "--log2-blocks", "13", "--device", "cpu"])
assert r["frames"] == 1 and r["num_active"] > 0, r
from ra_slam_tpu_torch.core.config import TrackingConfig
from ra_slam_tpu_torch.eval import trajectory_bench
for loop in (False, True):
    t = trajectory_bench.run_trajectory_eval(
        n_frames=3, width=160, height=120, loop_closure=loop, device="cpu",
        tcfg=TrackingConfig(max_map_points=256, max_keyframes=8))
    assert t["lost_frames"] == 0 and t["keyframes"] >= 1 and t["loop_closure"] == loop, t
import numpy as np
from ra_slam_tpu_torch.core.config import CameraConfig, FeatureConfig, SystemConfig, TsdfConfig
from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem
cam = dict(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120)
ds = SyntheticBoxDataset(num_frames=120, cam=SyntheticCameraSpec(**cam), radius=1.0)
cfg = SystemConfig(camera=CameraConfig(**cam), feature=FeatureConfig(max_num_keypoints=200, num_levels=2),
                   tsdf=TsdfConfig(voxel_size=0.05, truncation=0.3, log2_num_blocks=12, log2_hash_size=14,
                                   max_visible_blocks=2048, max_new_blocks=4096, width=160, height=120))
s = RaSlamSystem(cfg, "cpu")
fr = ds.frame(0)
assert s.feed_tracking_frame(fr.rgb, fr.depth, fr.timestamp).tracked
st = s.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, ht=fr.ht, lt=fr.lt)
assert "skipped" not in st and s.num_integrated == 1 and st["num_active"] > 0, st
for mod in pkgutil.walk_packages(ra_slam_tpu_torch.__path__, "ra_slam_tpu_torch."):
    importlib.import_module(mod.name)
leaked = [m for m in sys.modules if m == "ra_slam_tpu" or m.startswith("ra_slam_tpu.")]
assert not leaked, leaked
print("GUARD_OK")
"""


def test_port_imports_without_jax_yaml_cv2():
    """Every module of the port imports, one CPU frame fuses at a given
    pose, three are tracked with loop closing off and three with it on,
    and the facade tracks one frame and fuses it at the tracked pose,
    with jax, flax, yaml and cv2 unavailable and no ra_slam_tpu module
    loaded: the machine with the GPU has none of them."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0 and "GUARD_OK" in r.stdout, r.stdout + r.stderr


def test_use_slam_cli_tracks_and_fuses(tmp_path):
    """`--use-slam`: three VGA frames tracked by the facade at the
    defaults (1000 keypoints on 8 levels, 20000 landmarks) and fused at
    the tracked poses; ATE/RPE against the ground truth in the result,
    the trajectory written in the id + 3x4 format."""
    traj = tmp_path / "trajectory.txt"
    r = port_cli.main(ARGS + ["--use-slam", "--device", "cpu", "--download", str(tmp_path),
                              "--trajectory-out", str(traj)])
    assert r["frames"] == r["tracked_frames"] == 3 and r["alloc_failures"] == 0 and r["tsdf_rows"] > 0
    assert r["track_s"] > 0 and r["loop_closures"] == 0
    assert r["ate"]["matched_frames"] == 3 and r["ate"]["ate_rmse"] < 0.01, r["ate"]
    assert r["rpe"]["pairs"] == 2
    rows = np.loadtxt(traj)
    assert rows.shape == (3, 13) and list(rows[:, 0]) == [0, 1, 2]
    np.testing.assert_allclose(rows[0, 1:].reshape(3, 4), np.eye(4)[:3], atol=1e-6)  # the SLAM world is camera 0


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(ARGS + ["--device", "cuda"])


@pytest.mark.parametrize("flag", ["--sens", "--folder"])
def test_unported_readers_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported"):
        port_cli.main([flag, str(tmp_path), "--device", "cpu"])
