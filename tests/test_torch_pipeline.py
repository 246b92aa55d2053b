"""The known-pose CLI of the PyTorch port
(ra_slam_tpu_torch/pipeline/offline_eval.py) against the JAX package's,
on the CPU, its mesh, render and evaluation outputs, the map viewer, and
the port's import boundary (tests/test_torch_facade.py holds the
facade's tracked fusion against JAX)."""

import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from ra_slam_tpu.eval.scannet_eval import ScannetEval as JaxScannetEval
from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu.pipeline import offline_eval as jax_cli
from ra_slam_tpu.pipeline import viewer as jax_viewer
from ra_slam_tpu.pipeline.system import RaSlamSystem as JaxSystem
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.eval.ply import save_ply
from ra_slam_tpu_torch.io import synthetic as tsyn
from ra_slam_tpu_torch.map.synthetic_map import analytic_box_map
from ra_slam_tpu_torch.pipeline import offline_eval as port_cli
from ra_slam_tpu_torch.pipeline import viewer as port_viewer
from ra_slam_tpu_torch.utils.checkpoint import save_pytree

# the fast-tier arguments of tests/test_pipeline.py's CLI test
ARGS = ["--synthetic", "--max-frames", "3", "--voxel-size", "0.05",
        "--truncation", "0.3", "--log2-blocks", "13"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_offline_eval_matches_jax(tmp_path, monkeypatch):
    """Same counts as the JAX CLI, and a tsdf.bin with byte-equal xyz and
    tsdf/prob within the bounds. The JAX CLI runs op by op (see
    tests/torch_parity.py); its mesh dump, ~20 s op by op, is skipped
    (tests/test_torch_meshing.py holds meshing against JAX)."""
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
import importlib, os, pkgutil, sys, tempfile
for name in ("jax", "flax", "yaml", "cv2", "PIL", "msgpack"):
    sys.modules[name] = None  # any import of them raises ImportError
import ra_slam_tpu_torch
from ra_slam_tpu_torch.pipeline import offline_eval
out = tempfile.mkdtemp()
r = offline_eval.main(["--synthetic", "--max-frames", "1", "--voxel-size", "0.05",
                       "--truncation", "0.3", "--log2-blocks", "13", "--device", "cpu",
                       "--download", out, "--render-every", "1"])
assert r["frames"] == 1 and r["num_active"] > 0 and r["mesh_triangles"] > 0, r
assert os.path.getsize(os.path.join(out, "render_00000.png")) > 0
import dataclasses
from ra_slam_tpu_torch.io.folder import write_folder_dataset
from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
from ra_slam_tpu_torch.models.segmentation import InferenceEngine
small = SyntheticBoxDataset(num_frames=120, cam=SyntheticCameraSpec(fx=48.0, fy=48.0, cx=47.5, cy=31.5,
                                                                    width=96, height=64), radius=1.0)
write_folder_dataset(os.path.join(out, "rec"), [dataclasses.replace(small.frame(0), ht=None, lt=None)], small.camera)
InferenceEngine("__random__", 96, 64, device="cpu").save(os.path.join(out, "seg.msgpack"))
r = offline_eval.main(["--folder", os.path.join(out, "rec"), "--model", os.path.join(out, "seg.msgpack"),
                       "--voxel-size", "0.05", "--truncation", "0.3", "--log2-blocks", "13", "--device", "cpu"])
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
assert s.render(s.query_camera_pose(fr.timestamp))["hit"].shape == (120, 160)
assert s.download_all_mesh(*(os.path.join(out, n) for n in "vip"))[1] > 0
from ra_slam_tpu_torch.pipeline import viewer
from ra_slam_tpu_torch.utils.checkpoint import save_system
save_system(os.path.join(out, "ckpt"), s)
n = viewer.main(["--checkpoint", os.path.join(out, "ckpt"), "--out", os.path.join(out, "views"),
                 "--orbit", "2", "--voxel-size", "0.05", "--truncation", "0.3", "--log2-blocks", "12",
                 "--width", "160", "--height", "120", "--device", "cpu"])
assert n == 2 and len(os.listdir(os.path.join(out, "views"))) == 4
from ra_slam_tpu_torch.core.rectify import StereoRectifier
from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
from ra_slam_tpu_torch.features.stereo import dense_stereo_depth
from ra_slam_tpu_torch.io.capture import calib_to_yaml
calib = {side: dict(fx=80.0, fy=80.0, cx=79.5, cy=59.5, k1=-0.1, k2=0.01, k3=0.0, p1=0.0, p2=0.0)
         for side in ("left", "right")}
with open(os.path.join(out, "calib.yaml"), "w") as f:
    f.write(calib_to_yaml(dict(calib, baseline=0.12, rotation=[0.0, 0.001, 0.0]), 160, 120))
rect = StereoRectifier.from_yaml(os.path.join(out, "calib.yaml"), device="cpu")
left, right = rect.rectify(fr.rgb, ds.frame(1).rgb)
g = lambda a: rgb_to_gray(__import__("torch").as_tensor(a))
assert dense_stereo_depth(g(left), g(right), rect.focal_x_baseline, max_disparity=16)[0].shape == (120, 160)
from ra_slam_tpu_torch.io.prefetch import ByteQueue
from ra_slam_tpu_torch.io.sens import SensReader, write_sens
from ra_slam_tpu_torch.utils.data_logger import FrameLogger
write_sens(os.path.join(out, "s.sens"), [fr.rgb], [(fr.depth * 1000).astype(np.uint16)], [np.eye(4, dtype=np.float32)],
           np.array([[80.0, 0, 79.5], [0, 80.0, 59.5], [0, 0, 1]], np.float32))
assert [f.frame_id for f in SensReader(os.path.join(out, "s.sens")).prefetch(2, 2)] == [0]
assert ByteQueue(1).push(b"x")
lg = FrameLogger(os.path.join(out, "log"))
assert lg.log_frame(0, fr.rgb, fr.depth, ht=fr.ht, lt=fr.lt)
lg.close()
from ra_slam_tpu_torch.parallel import LocalMesh, create_sharded_map, make_sharded_integrate_step
from ra_slam_tpu_torch.parallel.sharded_map import extract_mesh_sharded
pmesh, pcfg = LocalMesh(2, "cpu"), cfg.tsdf
shards, pst = make_sharded_integrate_step(pmesh, pcfg, owner_mode="slab")(
    create_sharded_map(pcfg, pmesh), *(__import__("torch").as_tensor(a) for a in (fr.rgb, fr.depth, fr.ht, fr.lt)),
    s.tsdf_cam, s.query_camera_pose(fr.timestamp))
assert int(pst["num_active"]) > 0 and len(extract_mesh_sharded(shards, pmesh, pcfg, min_weight=0.5)[1]) > 0
import importlib.util
spec = importlib.util.spec_from_file_location("gen_eval_torch", os.path.join("scripts", "gen_eval_torch.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
for mod in pkgutil.walk_packages(ra_slam_tpu_torch.__path__, "ra_slam_tpu_torch."):
    importlib.import_module(mod.name)
leaked = [m for m in sys.modules if m == "ra_slam_tpu" or m.startswith("ra_slam_tpu.")]
assert not leaked, leaked
print("GUARD_OK")
"""


def test_port_imports_without_jax_yaml_cv2():
    """Every module of the port imports; one CPU frame fuses at a given
    pose and is meshed and rendered to PNG by the CLI; one frame of a
    logged folder the port writes is segmented by the default-width UNet
    from a checkpoint the port saves and fused by the CLI; three are tracked
    with loop closing off and three with it on; the facade tracks one
    frame, fuses it at the tracked pose, renders and meshes it, and the
    viewer renders its checkpoint; a rectifier reads `calib_to_yaml`'s
    text and rectifies a pair, dense stereo runs on it, a `.sens` file
    is prefetched and a frame logged; two slab shards fuse the frame on
    a `LocalMesh` and mesh it, and scripts/gen_eval_torch.py loads: with
    jax, flax, yaml, cv2, PIL and msgpack unavailable and no ra_slam_tpu
    module loaded (the port needs none of them on the machine with the
    GPU)."""
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


def test_offline_eval_mesh_render_and_eval(tmp_path):
    """`--download --render-every --eval-gt`: the three mesh dumps hold
    the counts of the result line, every index in range and no
    degenerate triangle; the PNGs decode (cv2) to RGBA renders; the
    `eval` summary equals the JAX ScannetEval's on the same tsdf.bin."""
    he = np.array([3.0, 2.0, 3.0])  # the synthetic room; its +x wall is high touch
    rng = np.random.default_rng(0)
    v = rng.uniform(-he, he, (20000, 3))
    axis = rng.integers(0, 3, len(v))
    side = rng.choice([-1.0, 1.0], len(v))
    v[np.arange(len(v)), axis] = side * he[axis]
    labels = np.where((axis == 0) & (side > 0), 5, 1)  # nyu40 chair (high touch) / wall
    gt = str(tmp_path / "gt.labels.ply")
    save_ply(gt, v, np.zeros((0, 3), np.int32), vertex_labels=labels)
    out = tmp_path / "out"
    r = port_cli.main(ARGS[:2] + ["5"] + ARGS[3:] + [
        "--device", "cpu", "--download", str(out), "--render-every", "4", "--eval-gt", gt])
    nv, nt = r["mesh_vertices"], r["mesh_triangles"]
    assert r["frames"] == 5 and nv > 1000 and nt > nv
    verts = np.fromfile(out / "mesh_vertices.bin", np.float32).reshape(-1, 3)
    idx = np.fromfile(out / "mesh_indices.bin", np.int32).reshape(-1, 3)
    prob = np.fromfile(out / "mesh_vertices_prob.bin", np.float32)
    assert verts.shape == (nv, 3) and idx.shape == (nt, 3) and prob.shape == (nv,)
    assert idx.min() >= 0 and idx.max() < nv and ((prob >= 0) & (prob <= 1)).all()
    assert ((idx[:, 0] != idx[:, 1]) & (idx[:, 1] != idx[:, 2]) & (idx[:, 0] != idx[:, 2])).all()
    assert np.isfinite(verts).all() and (np.abs(verts) <= he + 0.2).all()

    assert sorted(p.name for p in out.glob("render_*.png")) == ["render_00000.png", "render_00004.png"]
    png = cv2.imread(str(out / "render_00004.png"), cv2.IMREAD_UNCHANGED)
    assert png.shape == (480, 640, 4) and set(np.unique(png[..., 3])) == {0, 255}
    assert (png[..., 3] == 255).mean() > 0.02  # after 5 frames, weights pass the render gate

    assert r["eval"] == JaxScannetEval(str(out / "tsdf.bin"), gt).summary()
    assert r["eval"]["recall"] > 0.5


def test_viewer_paths_match_jax():
    """orbit_poses, follow_poses and shade_normal equal the JAX
    viewer's."""
    c = np.array([0.1, -0.2, 0.3])
    np.testing.assert_allclose(np.stack(port_viewer.orbit_poses(c, 2.0, -0.5, 5)),
                               np.stack(jax_viewer.orbit_poses(c, 2.0, -0.5, 5)), atol=0)
    traj = [np.asarray(SyntheticBoxDataset(num_frames=12, cam=SyntheticCameraSpec(**tp.CAM_KW),
                                           radius=1.0).frame(i).cam_T_world) for i in (0, 5)]
    with jax.disable_jit():
        j = jax_viewer.follow_poses(traj)
    np.testing.assert_allclose(np.stack(port_viewer.follow_poses(traj)), np.stack(j), atol=1e-6)
    rng = np.random.default_rng(0)
    n = rng.uniform(-1, 1, (6, 7, 3)).astype(np.float32)
    hit = rng.random((6, 7)) < 0.5
    np.testing.assert_array_equal(port_viewer.shade_normal(n, hit), jax_viewer.shade_normal(n, hit))


def test_viewer_cli_renders_a_checkpoint(tmp_path):
    """`python -m ra_slam_tpu_torch.pipeline.viewer` on a map checkpoint:
    an orbit and a follow path, RGBA and normal PNGs with hits."""
    cfg = TsdfConfig(voxel_size=0.05, truncation=0.15, log2_num_blocks=13, log2_hash_size=15,
                     width=160, height=120, raycast_min_weight=10.0)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    save_pytree(str(ckpt / "map.npz"), analytic_box_map(cfg, "cpu", half_extents=(1.5, 1.0, 1.5)))
    traj = tmp_path / "trajectory.txt"
    traj.write_text("0 1 0 0 0 0 1 0 0 0 0 1 0\n")
    views = tmp_path / "views"
    n = port_viewer.main(["--checkpoint", str(ckpt), "--out", str(views), "--orbit", "3",
                          "--trajectory", str(traj), "--voxel-size", "0.05", "--truncation", "0.15",
                          "--log2-blocks", "13", "--width", "160", "--height", "120", "--device", "cpu"])
    assert n == 4 and len(list(views.glob("*.png"))) == 8
    for i in range(4):
        rgba = cv2.imread(str(views / f"rgb_{i:05d}.png"), cv2.IMREAD_UNCHANGED)
        normal = cv2.imread(str(views / f"normal_{i:05d}.png"), cv2.IMREAD_UNCHANGED)
        assert rgba.shape == (120, 160, 4) and normal.shape == (120, 160, 3)
        assert (rgba[..., 3] == 255).mean() > 0.01, i


def test_viewer_cuda_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_viewer.main(["--checkpoint", str(tmp_path), "--out", str(tmp_path)])
