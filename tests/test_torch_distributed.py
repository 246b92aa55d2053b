"""Multi-process wiring of the PyTorch port (ra_slam_tpu_torch/parallel/
distributed.py and mesh.py) on the CPU: two gloo processes, one shard
each (`ProcessGroupMesh`), run the sharded fusion step and the
distributed BA solve and the exports, and every result equals the
same run over `LocalMesh(2)` in this process bit for bit (both meshes
add in shard order); a failing or lost shard fails a `LocalMesh` call within its
timeout; `bench_scaling` prints its JSON line.

The workers import no JAX: this process builds the inputs (the BA window
from tests/test_ba.py's problem) and hands them over in a file. Each
worker binds a free port's process group and has a timeout.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: F401  (two torch threads, as the workers)
from test_torch_dist_ba import ITERS, MAX_POINTS, TCAM, WINDOW, _problem
from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.parallel import (
    LocalMesh,
    create_sharded_map,
    make_gather_shards,
    make_sharded_integrate_step,
    solve_window_distributed,
)
from ra_slam_tpu_torch.parallel.sharded_map import extract_mesh_sharded
from ra_slam_tpu_torch.pipeline import bench_scaling
from ra_slam_tpu_torch.slam import ba as tba

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TsdfConfig(voxel_size=0.05, truncation=0.3, max_depth=6.0, log2_num_blocks=12, log2_hash_size=15,
                 max_visible_blocks=2048, width=160, height=120)
CAM = PinholeCamera.create(80.0, 80.0, 79.5, 59.5, 160, 120)
CHILD_TIMEOUT_S = 120

_WORKER = r"""
import sys, torch
rank, world, port, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(2)
from ra_slam_tpu_torch.parallel import (ProcessGroupMesh, create_sharded_map, global_mesh,
    initialize_distributed, make_gather_shards, make_sharded_integrate_step, process_info,
    solve_window_distributed)
from ra_slam_tpu_torch.parallel.sharded_map import extract_mesh_sharded
initialize_distributed(f"localhost:{port}", world, rank, device="cpu", timeout_s=60)
info = process_info()
assert info == {"process_index": rank, "process_count": world, "local_devices": 1, "global_devices": world}, info
d = torch.load(inp, weights_only=False)
mesh = global_mesh()
assert isinstance(mesh, ProcessGroupMesh) and mesh.size == world and mesh.local_shards == [rank]
shards = create_sharded_map(d["cfg"], mesh)
step = make_sharded_integrate_step(mesh, d["cfg"])
stats = []
for fr in d["frames"]:
    shards, st = step(shards, *fr, d["cam"], d["pose"])
    stats.append({k: int(v) for k, v in st.items()})
poses, points, bst = solve_window_distributed(d["win"], d["cam_ba"], ProcessGroupMesh("ba"), iterations=d["iters"])
g, dropped = make_gather_shards(mesh, d["cfg"])[0](shards)
slab = create_sharded_map(d["cfg"], mesh)
slab, _ = make_sharded_integrate_step(mesh, d["cfg"], owner_mode="slab", cell_log2=1)(slab, *d["frames"][0], d["cam"], d["pose"])
meshes = {mode: extract_mesh_sharded(slab, mesh, d["cfg"], cell_log2=1, min_weight=0.5, mode=mode)
          for mode in ("parallel", "sequential")}
torch.save({"shard": shards[0], "stats": stats, "poses": poses, "points": points,
            "rmse": bst.rmse_after, "gathered": g, "dropped": dropped, "meshes": meshes}, out)
torch.distributed.destroy_process_group()
print(f"rank {rank} OK", flush=True)
"""


def _frames():
    H, W = 120, 160
    vs, us = np.mgrid[0:H, 0:W]
    depth = torch.tensor((2.0 + 0.2 * np.sin(us / 17.0)).astype(np.float32))
    rgb = torch.tensor(np.stack([us % 256, vs % 256, (us + vs) % 256], -1).astype(np.float32))
    ht, lt = torch.full((H, W), 0.9), torch.full((H, W), 0.1)
    return [(rgb, depth, ht, lt)] * 2


def _same_map(a, b):
    for name in ("block_key", "block_slot", "active", "tsdf", "weight", "rgb", "prob", "alloc_failures",
                 "free_stack", "free_top"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.table.key, b.table.key) and torch.equal(a.table.value, b.table.value)


def test_two_gloo_processes_equal_local_mesh(tmp_path):
    """2 processes x 1 shard over gloo against LocalMesh(2), bit for bit:
    each rank's shard and the stats, the BA poses, points and rmse, the
    gathered map, and the slab halo export's mesh in both modes (the
    point-to-point `ppermute`; every rank gets every shard's mesh)."""
    _, _, _, tk, tl, num_kf, _ = _problem()
    win = tba.gather_window(tk, tl, num_kf, WINDOW, MAX_POINTS)
    pose = SE3.identity("cpu")
    inp = str(tmp_path / "inputs.pt")
    torch.save({"cfg": CFG, "cam": CAM, "pose": pose, "frames": _frames(), "win": win, "cam_ba": TCAM,
                "iters": ITERS}, inp)
    port = str(bench_scaling.free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2", port, inp, str(tmp_path / f"r{r}.pt")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for q in procs:
            outs.append(q.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    for r, (q, out) in enumerate(zip(procs, outs)):
        assert q.returncode == 0 and f"rank {r} OK" in out, f"rank {r} failed:\n{out}"

    mesh = LocalMesh(2, "cpu")
    shards = create_sharded_map(CFG, mesh)
    step = make_sharded_integrate_step(mesh, CFG)
    stats = []
    for fr in _frames():
        shards, st = step(shards, *fr, CAM, pose)
        stats.append({k: int(v) for k, v in st.items()})
    poses, points, bst = solve_window_distributed(win, TCAM, LocalMesh(2, "cpu", axis="ba"), iterations=ITERS)
    g, dropped = make_gather_shards(mesh, CFG)[0](shards)
    slab = create_sharded_map(CFG, mesh)
    slab, _ = make_sharded_integrate_step(mesh, CFG, owner_mode="slab", cell_log2=1)(slab, *_frames()[0], CAM, pose)
    meshes = {mode: extract_mesh_sharded(slab, mesh, CFG, cell_log2=1, min_weight=0.5, mode=mode)
              for mode in ("parallel", "sequential")}
    assert stats[-1]["num_active"] > 0 and stats[-1]["alloc_failures"] == 0 and len(meshes["parallel"][1]) > 0
    for r in range(2):
        got = torch.load(str(tmp_path / f"r{r}.pt"), weights_only=False)
        assert got["stats"] == stats
        _same_map(got["shard"], shards[r])
        assert torch.equal(got["poses"].R, poses.R) and torch.equal(got["poses"].t, poses.t)
        assert torch.equal(got["points"], points) and torch.equal(got["rmse"], bst.rmse_after)
        _same_map(got["gathered"], g)
        assert int(got["dropped"]) == int(dropped) == 0
        for mode, (v, t, p, info) in meshes.items():
            gv, gt, gp, ginfo = got["meshes"][mode]
            assert np.array_equal(gv, v) and np.array_equal(gt, t) and np.array_equal(gp, p) and ginfo == info


def test_local_mesh_collectives():
    """The collectives on 3 shards: values in shard order, sums added in
    shard order, the scatter and the permutation."""
    mesh = LocalMesh(3, "cpu")

    def body(ctx, x):
        return (ctx.index, ctx.all_gather(x), ctx.psum(x), ctx.psum_scatter(torch.cat([x, x, x])),
                ctx.ppermute(x, [(0, 1), (1, 2)]))

    xs = [torch.tensor([1.0, 2.0]) * (i + 1) for i in range(3)]
    out = mesh.run(body, xs)
    total = (xs[0] + xs[1]) + xs[2]
    for i, (idx, g, s, sc, pp) in enumerate(out):
        assert idx == i and torch.equal(g, torch.cat(xs)) and torch.equal(s, total)
        assert torch.equal(sc, total)
        assert torch.equal(pp, torch.zeros(2) if i == 0 else xs[i - 1])
    assert mesh.shape == {"map": 3} and list(mesh.shape.keys())[0] == "map"


def test_failing_shard_fails_the_call():
    """A shard that raises makes the call raise its error at once; a
    shard that never reaches the collective fails it at the timeout; no
    thread is left waiting at the barrier."""
    def raises(ctx, x):
        if ctx.index == 1:
            raise ValueError("shard 1 failed")
        return ctx.psum(x)

    xs = [torch.ones(2)] * 3
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="shard 1 failed"):
        LocalMesh(3, "cpu", timeout=30).run(raises, xs)
    assert time.monotonic() - t0 < 10

    def lost(ctx, x):
        if ctx.index == 1:
            time.sleep(4)
        return ctx.psum(x)

    before = threading.active_count()
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, threading.BrokenBarrierError)):
        LocalMesh(3, "cpu", timeout=1).run(lost, xs)
    assert time.monotonic() - t0 < 4
    time.sleep(4)
    assert threading.active_count() <= before


def test_bench_scaling_prints_its_json_line(capsys):
    out = bench_scaling.run(["--devices", "2", "--device", "cpu", "--frames", "2", "--voxel-size", "0.05",
                             "--log2-blocks", "12", "--log2-hash", "14"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert line["metric"] == "sharded_fused_frames_per_sec" and line["value"] > 0 and line["n_devices"] == 2
    assert line["fps_1dev"] > 0 and 0 < line["scaling_efficiency"] and "partitioning" in line["note"]
    assert line["process_count"] == 1


def test_nccl_spawn_without_gpus_raises():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two GPUs")
    with pytest.raises(RuntimeError, match="needs 2 GPUs"):
        bench_scaling.run(["--spawn", "2", "--device", "cuda", "--frames", "1"])
