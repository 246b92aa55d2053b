"""Tests of the PyTorch port's end-to-end paths on the GPU, through its
CLIs and scripts: known-pose fusion (`offline_eval --synthetic`) with
its map, mesh and renders checked against the room's geometry, the
recorded-data paths (`--folder --model`, `--sens`, `--sens --native-io`),
the full system (`--use-slam`), the semantic re-score and training
scripts, and `bench_scaling`'s launches.

They skip where torch sees no CUDA device. This file imports no JAX, so
that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda*.py
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from ra_slam_tpu_torch.ops import hamming, tsdf_fuse

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_FRAMES = 60  # known-pose fusion's frames, and the recorded folder's
SENS_FRAMES = 20  # the .sens path's frames
SCANNET_COLOR = (1296, 968)  # ScanNet's colour size; its depth is 640x480

# Every bound of this file. The room is the box |x| <= 3, |y| <= 2,
# |z| <= 3 m; its +x wall is the high-touch class (p = 0.95, the other
# walls 0.05).
TOL = {
    # the fused surface voxels' distance to the walls, median and p99, m
    "wall_median_m": 0.015, "wall_p99_m": 0.05,
    # the same for the full system, its map carried into the room's frame
    "slam_wall_median_m": 0.02, "slam_wall_p99_m": 0.08,
    # mean prob of the surface on the high-touch wall, and elsewhere
    "ht_prob": 0.8, "lt_prob": 0.2,
    # ATE of a tracked run, m (the repo's north-star bound)
    "ate_m": 0.05,
    # a render against the analytic depth: coverage, and RMSE in voxels
    "render_coverage": 0.7, "render_rmse_voxels": 3.0,
    # the mesh's vertices: p95 distance to the walls, in voxels
    "mesh_wall_p95_voxels": 2.0,
    # scripts/score_torch_semantic.py's IoUs, card against CPU
    "rescore": 0.005,
    # scripts/train_torch_semantic.py, 300 steps from the committed JAX
    # init (SEMANTIC_r05.json, JAX on a TPU: loss 0.6504 -> 0.0352; IoUs
    # 0.9695 / 0.9899 / 0.9754): the first loss, the last, the IoUs
    "train_first": 0.6504, "train_first_tol": 0.01, "train_last": 0.1, "train_iou": 0.9,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _load_script(name):
    """A module of scripts/ by file path (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(HERE), "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _orbit():
    """The VGA orbit `offline_eval --synthetic` reads."""
    from ra_slam_tpu_torch.pipeline import offline_eval

    return offline_eval.load_dataset(offline_eval.build_parser().parse_args(["--synthetic"]))


def _dump(out):
    """tsdf.bin's rows (x, y, z, tsdf, prob) under a `--download` dir."""
    return np.fromfile(os.path.join(out, "tsdf.bin"), "<f4").reshape(-1, 5)


def _walls(xyz, tsdf, prob):
    """(distance of the surface voxels (|tsdf| < 0.2) to the room's
    walls, their mean prob on the +x wall, elsewhere); asserts tsdf in
    [-1, 1] and prob in [0, 1]."""
    assert np.isfinite(xyz).all() and np.isfinite(tsdf).all() and np.isfinite(prob).all()
    assert (np.abs(tsdf) <= 1).all() and ((prob >= 0) & (prob <= 1)).all()
    surf = np.abs(tsdf) < 0.2
    a = np.abs(xyz[surf])
    dist = np.abs(np.minimum(np.minimum(3.0 - a[:, 0], 2.0 - a[:, 1]), 3.0 - a[:, 2]))
    ht = xyz[surf, 0] > 2.95
    return dist, prob[surf][ht].mean() if ht.any() else float("nan"), prob[surf][xyz[surf, 0] < 2.9].mean()


def _check_recorded(r, rows, n, launches):
    """A recorded path's run: every frame fused (a launch each), no
    allocation failure, the dump's rows as reported, on the walls."""
    assert r["frames"] == n and launches >= n, (r, launches)
    assert r["alloc_failures"] == 0 and len(rows) == r["tsdf_rows"] > 0, r
    dist, _, _ = _walls(rows[:, :3], rows[:, 3], rows[:, 4])
    assert np.median(dist) <= TOL["wall_median_m"] and np.quantile(dist, 0.99) <= TOL["wall_p99_m"]


@pytest.fixture(scope="module")
def main_path(tmp_path_factory):
    """`offline_eval --synthetic --max-frames 60 --download` on the card:
    (its result, the fuse launches, the dump's tsdf rows, mesh vertices,
    triangles and vertex probs, the system it ran)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from ra_slam_tpu_torch.pipeline import offline_eval
    from ra_slam_tpu_torch.pipeline.system import RaSlamSystem

    out = str(tmp_path_factory.mktemp("main_path"))
    seen = {}
    saved = RaSlamSystem.download_all_mesh

    def spy(system, *paths):
        seen["system"] = system
        return saved(system, *paths)

    n0 = tsdf_fuse.LAUNCHES
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RaSlamSystem, "download_all_mesh", spy)
        r = offline_eval.main(["--synthetic", "--max-frames", str(MAIN_FRAMES), "--download", out])
    mesh = (np.fromfile(os.path.join(out, "mesh_vertices.bin"), "<f4").reshape(-1, 3),
            np.fromfile(os.path.join(out, "mesh_indices.bin"), "<i4").reshape(-1, 3),
            np.fromfile(os.path.join(out, "mesh_vertices_prob.bin"), "<f4"))
    return r, tsdf_fuse.LAUNCHES - n0, _dump(out), mesh, seen["system"]


@pytest.mark.cuda
def test_main_path_fuses_the_room(main_path):
    """60 frames fused, one kernel launch each at least, no allocation
    failure, the dump's rows as reported; the surface on the walls and
    the semantics on the high-touch wall."""
    r, launches, rows, _, _ = main_path
    assert r["frames"] == MAIN_FRAMES and launches >= MAIN_FRAMES, (r, launches)
    assert r["alloc_failures"] == 0 and r["num_active"] > 0, r
    assert len(rows) == r["tsdf_rows"] > 0
    dist, p_ht, p_lt = _walls(rows[:, :3], rows[:, 3], rows[:, 4])
    assert np.median(dist) < TOL["wall_median_m"] and np.quantile(dist, 0.99) < TOL["wall_p99_m"]
    assert p_ht > TOL["ht_prob"] and p_lt < TOL["lt_prob"], (p_ht, p_lt)


@pytest.mark.cuda
def test_main_path_mesh(main_path):
    """The mesh the run dumps (marching tetrahedra): counts as reported,
    indices in range, no degenerate triangle, 95% of the vertices within
    2 voxels of a wall, mean vertex prob > 0.8 on the high-touch wall; a
    second extraction of the same map equal to it."""
    from ra_slam_tpu_torch.map.meshing import extract_mesh

    r, _, _, (verts, tris, vprob), system = main_path
    nv, nt = r["mesh_vertices"], r["mesh_triangles"]
    assert len(verts) == nv == len(vprob) and len(tris) == nt > 0
    assert tris.min() >= 0 and tris.max() < nv
    assert not ((tris[:, 0] == tris[:, 1]) | (tris[:, 1] == tris[:, 2]) | (tris[:, 0] == tris[:, 2])).any()
    wall_d = np.min(np.abs(np.abs(verts) - np.array([3.0, 2.0, 3.0])[None]), axis=1)
    assert np.percentile(wall_d, 95) < TOL["mesh_wall_p95_voxels"] * system.cfg.tsdf.voxel_size
    assert vprob[verts[:, 0] > 2.95].mean() > TOL["ht_prob"]
    v2, i2, p2 = extract_mesh(system.map, system.cfg.tsdf)
    assert np.array_equal(i2, tris) and np.array_equal(v2, verts) and np.array_equal(p2, vprob)


@pytest.mark.cuda
def test_render_sweep_of_the_main_path_map(main_path):
    """`RaSlamSystem.render` at the 60 orbit poses at VGA: no shell block
    dropped at any; at frame 0's pose the rendered depth against the
    dataset's analytic depth, coverage > 0.7 and RMSE < 3 voxels."""
    from ra_slam_tpu_torch.core.se3 import SE3

    system = main_path[4]
    ds = _orbit()
    for i in range(MAIN_FRAMES):
        pose = np.linalg.inv(ds.world_T_cam(i).astype(np.float64)).astype(np.float32)
        out = system.render(SE3.from_matrix(torch.as_tensor(pose)))
        assert int(out["dropped_splats"]) == 0, i
        if i == 0:
            depth, hit = out["depth"].cpu().numpy(), out["hit"].cpu().numpy()
    gt = ds.frame(0).depth
    sel = hit & (gt > 0)
    rmse = float(np.sqrt(np.mean((depth[sel] - gt[sel]) ** 2)))
    assert sel.mean() > TOL["render_coverage"], sel.mean()
    assert rmse < TOL["render_rmse_voxels"] * system.cfg.tsdf.voxel_size, rmse


@pytest.mark.cuda
def test_recorded_folder_path(cuda, tmp_path, monkeypatch):
    """60 VGA orbit frames logged without maps by the port's folder
    writer, segmented by the default-width UNet from a checkpoint the
    port saves, fused by `offline_eval --folder --model` on the card:
    the UNet run once a frame, the recorded path's gates."""
    from ra_slam_tpu_torch.io import folder as folder_io
    from ra_slam_tpu_torch.models import segmentation as seg
    from ra_slam_tpu_torch.pipeline import offline_eval

    ds = _orbit()
    rec, ckpt, out = (str(tmp_path / n) for n in ("rec", "seg.msgpack", "out"))
    folder_io.write_folder_dataset(
        rec, [dataclasses.replace(ds.frame(i), ht=None, lt=None) for i in range(MAIN_FRAMES)], ds.camera)
    seg.InferenceEngine("__random__", 640, 480, device=cuda).save(ckpt)
    calls = []
    forward = seg.InferenceEngine.forward
    monkeypatch.setattr(seg.InferenceEngine, "forward", lambda self, x: calls.append(1) or forward(self, x))
    n0 = tsdf_fuse.LAUNCHES
    r = offline_eval.main(["--folder", rec, "--model", ckpt, "--max-frames", str(MAIN_FRAMES), "--download", out])
    _check_recorded(r, _dump(out), MAIN_FRAMES, tsdf_fuse.LAUNCHES - n0)
    assert len(calls) == MAIN_FRAMES


def _scannet_like_sens(path, ds, n):
    """A .sens of the orbit's first `n` frames as ScanNet lays one out:
    PNG colour at 1296x968 (the orbit rendered at that size), 16-bit
    depth in mm at 640x480, the depth camera's intrinsics."""
    from ra_slam_tpu_torch.io.sens import write_sens
    from ra_slam_tpu_torch.io.synthetic import SyntheticCameraSpec, render_box_room

    cw, ch = SCANNET_COLOR
    spec = ds.spec
    sx, sy = cw / spec.width, ch / spec.height
    big = SyntheticCameraSpec(fx=spec.fx * sx, fy=spec.fy * sy, cx=(spec.cx + 0.5) * sx - 0.5,
                              cy=(spec.cy + 0.5) * sy - 0.5, width=cw, height=ch)
    rgbs, depths, c2w = [], [], []
    for i in range(n):
        f = ds.frame(i)
        rgbs.append(render_box_room(big, ds.world_T_cam(i), ds.half_extents)[0])
        depths.append(np.clip(f.depth * 1000.0, 0, 65535).astype(np.uint16))
        c2w.append(np.linalg.inv(np.asarray(f.cam_T_world, np.float64)).astype(np.float32))
    k = np.array([[spec.fx, 0, spec.cx], [0, spec.fy, spec.cy], [0, 0, 1]], np.float32)
    write_sens(path, rgbs, depths, c2w, k, depth_shift=1000.0)


@pytest.mark.cuda
def test_recorded_sens_path_and_native_io(cuda, tmp_path):
    """`offline_eval --sens` over 20 frames the port writes as ScanNet
    lays them out (the colour resized to the depth size on read): the
    recorded path's gates; then `--sens --native-io` over the same file:
    the same tsdf.bin byte for byte, the same frames, blocks and rows."""
    from ra_slam_tpu_torch.pipeline import offline_eval

    path = str(tmp_path / "scene.sens")
    _scannet_like_sens(path, _orbit(), SENS_FRAMES)
    runs = {}
    for flags in ((), ("--native-io",)):
        out = str(tmp_path / f"out{len(flags)}")
        n0 = tsdf_fuse.LAUNCHES
        r = offline_eval.main(["--sens", path, *flags, "--max-frames", str(SENS_FRAMES), "--download", out])
        runs[flags] = r, _dump(out)
        _check_recorded(r, runs[flags][1], SENS_FRAMES, tsdf_fuse.LAUNCHES - n0)
    (plain, rows), (native, native_rows) = runs[()], runs[("--native-io",)]
    assert np.array_equal(native_rows, rows)
    assert all(native[k] == plain[k] for k in ("frames", "num_active", "tsdf_rows"))


@pytest.mark.cuda
def test_rescore_cuda_matches_cpu(cuda):
    """scripts/score_torch_semantic.py on the card and on the CPU: the 2D
    and voxel IoUs within 0.005 of each other."""
    mod = _load_script("score_torch_semantic")
    gpu, cpu = mod.score("cuda"), mod.score("cpu")
    for key in ("iou_2d_high_touch", "iou_2d_low_touch", "voxel_iou_high_touch"):
        assert abs(gpu[key] - cpu[key]) <= TOL["rescore"], (key, gpu[key], cpu[key])


@pytest.mark.cuda
def test_full_system_tracks_and_fuses(cuda, tmp_path):
    """`offline_eval --synthetic --use-slam` over the 120 VGA frames at the
    defaults (1000 keypoints on 8 levels, 20000 landmarks, 256 keyframes,
    1 cm voxels), fusing at the tracked poses: every tracked frame fused,
    no allocation failure, both kernels launched every frame, the ATE
    within 0.05 m, and the dumped surface, carried from the first
    camera's frame into the room's, on the room's walls."""
    from ra_slam_tpu_torch.pipeline import offline_eval

    frames = 120
    world_T_cam0 = np.linalg.inv(np.asarray(_orbit().frame(0).cam_T_world, np.float64))
    f0, h0 = tsdf_fuse.LAUNCHES, hamming.LAUNCHES
    r = offline_eval.main(["--synthetic", "--use-slam", "--max-frames", str(frames), "--download", str(tmp_path)])
    assert r["frames"] == r["tracked_frames"] > 0 and r["alloc_failures"] == 0, r
    assert tsdf_fuse.LAUNCHES - f0 >= r["frames"] and hamming.LAUNCHES - h0 >= frames
    assert r["ate"]["ate_rmse"] <= TOL["ate_m"], r["ate"]
    rows = _dump(str(tmp_path))
    xyz = rows[:, :3].astype(np.float64) @ world_T_cam0[:3, :3].T + world_T_cam0[:3, 3]
    dist, p_ht, _ = _walls(xyz, rows[:, 3], rows[:, 4])
    assert np.median(dist) <= TOL["slam_wall_median_m"] and np.quantile(dist, 0.99) <= TOL["slam_wall_p99_m"]
    assert p_ht > TOL["ht_prob"], p_ht


@pytest.mark.cuda
def test_training_on_card_scores(cuda, tmp_path):
    """scripts/train_torch_semantic.py on the card from the committed JAX
    init, 300 steps: the first loss within 0.01 of 0.6504, the last below
    0.1; the weights re-scored by scripts/score_torch_semantic.py
    --weights: 2D high-touch and voxel IoU above 0.9."""
    trainer, scorer = _load_script("train_torch_semantic"), _load_script("score_torch_semantic")
    weights = str(tmp_path / "seg.msgpack")
    first, last = trainer.main(["--out", weights, "--device", "cuda"])["train_loss_first_last"]
    assert abs(first - TOL["train_first"]) <= TOL["train_first_tol"] and last < TOL["train_last"], (first, last)
    sc = scorer.main(["--weights", weights, "--device", "cuda"])
    assert sc["iou_2d_high_touch"] > TOL["train_iou"] and sc["voxel_iou_high_touch"] > TOL["train_iou"], sc


@pytest.mark.cuda
def test_bench_scaling_launches_every_shard(cuda):
    """`bench_scaling` on the card at 1, 2 and 4 shards over 4 frames: a
    rate each, and the fuse kernel launched once a shard a frame at
    least."""
    from ra_slam_tpu_torch.pipeline import bench_scaling

    frames, n0 = 4, tsdf_fuse.LAUNCHES
    rows = [bench_scaling.run(["--devices", str(k), "--device", "cuda", "--frames", str(frames)]) for k in (1, 2, 4)]
    assert all(r["value"] > 0 for r in rows), rows
    assert tsdf_fuse.LAUNCHES - n0 >= frames * (1 + 2 + 4)
