#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ra_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository. Ten phases, two of the map
readers (3b, 3c), the recorded-data path (2b, 3d-3h), training (11),
the live robot path (12-15), and the parallel layer, JPEG encoding,
the EVAL rows, the carried steps and the pyramid shapes (16-20d), none of whose failures is caught; each prints its
wall time:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     the builds of the CUDA kernels from csrc/ (the fuse kernel and the
     Hamming kernel, one nvcc each, started together), and the JPEG
     decoder probe (`ctypes.util.find_library` for turbojpeg, jpeg and
     nvjpeg, nvjpeg under the CUDA toolkit; whether torchvision and
     msgpack import);
  2. the kernel against its plain PyTorch version at the main path's
     shapes: after 10 fused frames of the VGA synthetic orbit at the
     offline_eval defaults (1 cm voxels, 2^17 blocks, 2^19 hash slots,
     16384 visible blocks), one more frame through each, from the same
     state; fields within the stated bounds, the same carve releases,
     median times over 20 repeats with CUDA events and profiler device
     times, each call after a 256 MiB write that flushes the L2, and the
     kernel's share of its bound (bytes over 3.35 TB/s against float32
     operations over 67 TFLOP/s);
 2b. the main path's configuration fused over the orbit's first 3 VGA
     frames on the card and on the CPU: keys, table, free stack and stats
     exactly equal, the payload within TOL;
  3. the known-pose fusion path: `ra_slam_tpu_torch.pipeline.offline_eval
     --download` over 60 frames on cuda, with the kernel's launch count
     read around it, and the dumped map checked against the room's known
     geometry; the mesh it dumps (marching tetrahedra) checked too:
     counts equal to the result line, indices in range, no degenerate
     triangle, 95% of the vertices within 2 voxels of a wall, mean vertex
     prob > 0.8 on the high-touch wall; the extraction's wall time in
     the CLI (cold) and again on the same map (warm, median of 3), its
     peak device memory;
 3b. raycast on phase 3's map: `RaSlamSystem.render` at the 60 orbit
     poses at VGA, no shell block dropped at any, CUDA events around each
     render (renders/s, peak memory); at frame 0's pose the rendered
     depth against the dataset's analytic depth (coverage > 0.7, RMSE <
     3 voxels);
 3c. the readers on the card against the same on the CPU: the analytic
     box room at 4 cm built on both, meshed on both (counts and indices
     exactly equal, vertices and probabilities within one u16 step) and
     rendered at one VGA pose on both (hit mask and dropped count equal,
     depth within 1e-5 but where two splats within one 13-bit depth step
     swap, at most 0.1% of the hits, normal 1e-5 and rgba 1e-3 away from
     those);
 3d. the recorded-data main path: 60 VGA orbit frames logged without
     maps by the port's folder writer, `offline_eval --folder --model`
     with the default-width UNet (random weights, a checkpoint the port
     saves) on cuda: >= 60 fuse launches, no allocation failure, the
     surface on the walls, prob in [0, 1]; fused f/s, the UNet's time per
     frame (CUDA events around the forward and `segment`, the host clock
     around `infer_one`), PNG decode ms per frame, peak memory;
 3e. `offline_eval --sens` over 20 frames the port writes as ScanNet lays
     them out (PNG colour 1296x968, depth 640x480), the same gates; with
     nvjpeg, the JPEG fixture (tests/data) against cv2's pixels;
 3f. the UNet on the card against the CPU (TF32 off): the default-width
     net on a VGA frame, the trained (16, 32, 64) weights on two held-out
     frames; the resizes on the card against the CPU, exactly;
 3g. the segmentation latency CLI at VGA (200 iterations), and the
     forward alone against its bound (116.6 GFLOP over the bf16 peak);
 3h. scripts/score_torch_semantic.py on the card and on the CPU: 2D and
     voxel IoUs within 0.005 of each other, beside SEMANTIC_r05.json's;
  4. the Hamming kernel against its plain PyTorch version, exactly equal,
     at the bench case 1000 x 20000 with random words, at the tracking
     shape (the frame's descriptors against the landmark map after a few
     tracked VGA frames), at ragged shapes, with kb % 4 != 0 and with an
     empty side; at the two large shapes the library yardstick (one
     torch.mm of the +-1 forms, checked equal after (256 - x) / 2), the
     cold-L2 CUDA-event times of kernel, plain version and library call,
     the profiler device times of kernel and plain version, and the
     shares of the bound (the output bytes over 3.35 TB/s);
  5. the tracking path without loop closing:
     `ra_slam_tpu_torch.eval.trajectory_bench` at 640x480, --no-loop,
     150 frames on cuda, with the Hamming kernel's launch count read
     around it; 0 lost frames, ATE <= 0.05 m (the repo's north-star
     bound) and one launch per frame at least;
  6. the same with loop closing on (the north star's loop-on arm): 0 lost
     frames, at least one closure, at most 2 relocalizations, ATE <=
     0.05 m and below phase 5's, one launch per frame at least; the
     CUDA-event time of each close-branch stage (PGO, landmark
     correction, global BA);
  7. BA and PGO on the card against the same on the CPU, from phase 6's
     final state: one global-BA window solve and one pose-graph
     optimisation, the largest pose and point differences within the
     stated bounds, whether two card solves agree bit for bit, and the
     CUDA-event time of each;
  8. the full system: `offline_eval --synthetic --use-slam` over all 120
     VGA frames at the defaults (1000 keypoints on 8 levels, 20000
     landmarks, 256 keyframes, 1 cm voxels), fusing at the tracked
     poses: every tracked frame fused, no allocation failure, ATE <=
     0.05 m, both kernels launched, and the dumped surface (carried from
     the first camera's frame into the room's) on the room's walls;
  9. stereo tracking: 6 rectified VGA pairs through
     `SlamSystem.feed_stereo_frame`, every frame tracked within 0.1 m;
 11. training: scripts/train_torch_semantic.py on the card from the
     committed JAX init, 300 steps (first loss within 0.01 of 0.6504,
     the last below 0.1), the weights re-scored by
     scripts/score_torch_semantic.py --weights (2D high-touch and voxel
     IoU above 0.9), and one float32 step (TF32 off) on the card and on
     the CPU from the same parameters and batch, each gradient within
     TRAIN_GRAD_TOL of its tensor's largest |g|, while the same step's
     gradients with cuDNN's TF32 on (the control) must exceed it;
 12. dense stereo (features/stereo.py) at the ZED's 672x376, D = 64, on a
     synthetic pair: card against CPU (valid equal where no out-of-range
     cost reaches the decision, depth within 1e-6), coverage of the
     columns >= 64 above 0.5, median relative error against the analytic
     depth below 0.05; the time per call and peak memory;
 13. rectification (core/rectify.py) from a ZED-like calibration at VGA:
     a uint8 pair remapped on the card equals the CPU's; time per pair;
 14. `live.run` with fake cameras on the card for 60 frames: rectified
     672x376 pairs feed the tracking thread, the left image with its
     dense stereo depth (io/cameras.py:ZedDepthCamera) the mapping
     thread, which segments it with the default-width UNet (random
     weights, from a checkpoint the port saves) outside the facade's lock
     while the tracking thread works; both threads reach 60 frames, ATE
     <= 0.05 m, >= 30 frames fused without allocation failure, the UNet
     run on every fused frame with its high-touch maps and the fused
     voxels' probabilities in [0, 1], a preview PNG decodes, both kernels
     launched; f/s per thread and where each thread's time goes;
 15. `offline_eval --sens --native-io` over 3e's file (run inside 3e's
     phase): the same tsdf.bin as 3e's run, byte for byte; f/s beside
     3e's;
 16. sharded fusion: 4 `LocalMesh` hash shards on the card fuse the main
     path's 60 frames (its map configuration): num_active equal to the
     single map's on the card, no allocation failure, the shards' union
     (keys, tsdf, weight, rgb, prob) within SHARD_TOL of the single map;
     `LocalMesh(1)` and `ProcessGroupMesh` over NCCL at world size 1 the
     same map bit for bit; the fuse kernel at one shard's shape against
     its plain version (times, bound); then 4 slab shards, meshed by
     `extract_mesh_sharded` in both modes against the gathered map's
     `extract_mesh` (triangle counts equal, centroids within 1 mm both
     ways, nothing dropped) with the peak blocks per shard; f/s, fuse
     launches, peak memory;
 17. distributed BA (inside phase 7's slot, on phase 6's system):
     `solve_window_distributed` over 4 shards on tests/test_dist_ba.py's
     window against `solve_window` on the card (poses 1e-3, points
     5e-3) and against itself on the CPU (DEV_VS_CPU_TOL, phase 7's
     bound; `solve_window`'s own card-vs-CPU difference beside it), the
     time of each; `refine_map` over `LocalMesh(2)`: finite, rmse_after <=
     rmse_before + 0.5;
 18. `bench_scaling` on the card at 1, 2 and 4 shards at the headline
     scale (1 cm, 2^17 blocks, 2^19 slots, 24 frames), its JSON lines;
 19. JPEG: 20 orbit frames encoded by nvjpeg and by cv2 at quality 95,
     both decoded by nvjpeg: PSNR within JPEG_PSNR_DB of each other;
     `write_sens(COLOR_JPEG)` on the card read back by `SensReader`:
     depth exact, colour within the same bound;
 20. the EVAL matrix's seed-0 rows (hardened scene, 150 VGA frames) loop
     on and off: >= 1 closure loop on, ATE loop on below loop off, the
     lost frames and closures of the JAX package as it stands, run op by
     op, and each ATE within EVAL_ATE_TOL of its (EVAL_JAX_SEED0; the
     jitted rows and `EVAL_r05.json`'s older rows printed beside);
 20b. the carried steps of tests/test_torch_lockstep.py on the card: each
     fixture frame's ORB keypoints on the card equal to the CPU's bit for
     bit (uv, valid, score, descriptors); then from each fixture's JAX
     state (tests/data/lockstep_*.npz: frames 17 and 23 of the EVAL `ba1`
     row, its first relocalization, the first windowed BA after it), one
     `feed_rgbd_frame`: every discrete `FrameInfo` field equal to the JAX
     package's op-by-op step stored there, the pose within 1e-5;
 20c. the EVAL `ba1` row (BA at every keyframe, seed 0, 150 VGA frames)
     free-running on the card: ATE, lost frames, relocalizations,
     keyframes and tracked f/s beside the port's row on the CPU and the
     JAX package's, op by op and jitted (tests/data/lockstep_traces.json,
     written by scripts/lockstep_torch_jax.py), and the first frame at
     which the card's discrete trace parts from each; reported, not
     gated;
 20d. at every input shape the port builds a pyramid for (640x480 and
     672x376 at 8 levels, 320x240 at 4), a frame of the EVAL scene: every
     level, its blur and the ORB keypoints (uv, valid, score,
     descriptors) on the card equal to the CPU's bit for bit (no Hamming
     launch);
 10. a JSON line of the kernels' numbers (launches summed over every
     path, 3d, 3e, 14-16, 18 and 20-20c included; times, bound and library
     time at the main path's shapes: the fuse kernel at frame 10, the
     Hamming kernel at the tracking shape), then the result line.

It exits non-zero, printing no result, when torch sees no CUDA device
or when the package is not beside it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack

import numpy as np
import torch

FRAMES_BEFORE = 10  # fused frames before the kernel/plain comparison
MAIN_FRAMES = 60
TRACK_FRAMES = 150  # the tracking path's frames (trajectory_bench)
TRACK_WARM = 5  # tracked frames before the Hamming kernel/plain comparison
ATE_BOUND_M = 0.05  # tests/test_trajectory_north_star.py
FULL_FRAMES = 120  # the full system's frames: the whole VGA orbit
STEREO_FRAMES = 6
# card vs CPU of one BA window solve and one PGO (float32, TF32 off;
# the same operations summed in other orders)
DEV_VS_CPU_TOL = 1e-4
KERNELS = ("tsdf_fuse", "hamming")
DEV_VS_CPU_FRAMES = 3  # VGA frames fused on the card and on the CPU (phase 2b)
SENS_FRAMES = 20  # the .sens path's frames (phase 3e)
SCANNET_COLOR = (1296, 968)  # ScanNet's colour size; its depth is 640x480
SEG_ITERS = 200  # the segmentation latency CLI's iterations (phase 3g)
# the UNet on the card against the CPU, and the port's against the JAX
# net on the CPU (tests/test_torch_segmentation.py): bf16 summation order
SEG_PROB_TOL, SEG_FLIP_SHARE = 0.06, 1e-3
# nvjpeg's pixels against cv2's (libjpeg) on the JPEG fixture: another
# IDCT and chroma upsampling (measured on the H100: max 81 levels, mean
# 3.11, at the fixture's block of noise)
JPEG_MAX_TOL, JPEG_MEAN_TOL = 96, 4.0
RESCORE_TOL = 0.005  # the re-scored IoUs, card against the CPU
# phase 11: the card-trained weights against SEMANTIC_r05.json (loss
# 0.6504 -> 0.0352 on a TPU; IoUs 0.9695 / 0.9899 / 0.9754)
TRAIN_FIRST_TOL, TRAIN_LAST_BOUND, TRAIN_IOU_BOUND = 0.01, 0.1, 0.9
# one float32 training step, card vs CPU (TF32 off): the largest gradient
# difference over the tensor's largest |g|; sums of ~3e5 float32 terms in
# other orders, the conv biases' mostly cancelling. The control, the same
# step on the card with cuDNN's TF32 on, must land above the bound
# (measured on the H100: 2.76e-4 with TF32 off, 1.17e-2 with it on).
TRAIN_GRAD_TOL = 1e-3
# phases 12-14: the ZED's VGA eye size and a rectified focal length like
# the ZED-like calibration's (350.12 px)
ZED_VGA, ZED_FX = (672, 376), 350.0
DENSE_D = 64  # io/cameras.py's max_disparity
SHARDS = 4  # phases 16 and 17: LocalMesh shards on the one card
SHARD_FRAMES = 60  # phase 16: the main path's frames, sharded
# phase 16: the shards' union against the single map (each voxel's
# update is the same operations on the same pixel, wherever it lives)
SHARD_TOL = 1e-5
# phase 17: the distributed solve card vs CPU (TF32 off) is held to
# phase 7's DEV_VS_CPU_TOL: 8 GN iterations from a 7 px start, summed in
# other orders, leave ~1.5e-5 m on points at 3-6 m (measured on the H100;
# solve_window's own card-vs-CPU difference on the window is printed)
# phase 18: scripts/gen_scaling.py's headline scale
SCALING_ARGS = ["--voxel-size", "0.01", "--log2-blocks", "17", "--log2-hash", "19", "--frames", "24"]
JPEG_FRAMES = 20  # phase 19
JPEG_PSNR_DB = 1.0  # nvjpeg's PSNR against cv2's at quality 95
# phase 20: the EVAL matrix's seed-0 rows, loop on / off. EVAL_r05.json
# records the JAX package as it stood in round 5 (ATE 0.0090 / 0.0134 m,
# no frame lost). The port is held to the JAX package as it stands, run
# op by op (its source's own float32 operations: scripts/
# lockstep_torch_jax.py --mode free-op-by-op on a CPU), which tracks
# every frame; jitted, XLA contracts multiply-adds and the JAX package
# loses frame 116 (scripts/eval_matrix_jax.py: EVAL_JAX_JIT_SEED0, printed
# beside)
EVAL_R05_ATE = {True: 0.0090, False: 0.0134}
EVAL_JAX_SEED0 = {True: {"ate_rmse_m": 0.0100, "lost_frames": 0, "loop_closures": 4},
                  False: {"ate_rmse_m": 0.0152, "lost_frames": 0, "loop_closures": 0}}
EVAL_JAX_JIT_SEED0 = {True: {"ate_rmse_m": 0.0112, "lost_frames": 1, "loop_closures": 4},
                      False: {"ate_rmse_m": 0.0159, "lost_frames": 1, "loop_closures": 0}}
EVAL_ATE_TOL = 0.002
# phase 20b: the carried steps of tests/test_torch_lockstep.py, held to
# the JAX package's op-by-op step stored in each fixture
LOCKSTEP_DISCRETE = ("tracked", "num_matches", "num_inliers", "inserted_keyframe", "relocalized",
                     "loop_cand", "loop_inliers", "loop_closed", "ba_dropped")
LOCKSTEP_POSE_TOL = 1e-5
# phase 20d: every pyramid the port builds ((width, height), levels) and
# the ORB it feeds: the facade's default, the live cell's, the tests'
PYRAMID_SHAPES = (((640, 480), 8, {}), (ZED_VGA, 8, dict(max_num_keypoints=1000, num_levels=3)),
                  ((320, 240), 4, dict(max_num_keypoints=300, num_levels=4)))
# dense stereo card vs CPU: `valid` may differ only where a sentinel cost
# (1e9, summed in another order) reaches the decision, left of column
# 2 D + 8; depth is the same float32 division where both are valid
DENSE_EDGE_SHARE, DENSE_DEPTH_TOL = 0.02, 1e-6
LIVE_FRAMES, LIVE_MIN_FUSED = 60, 30  # phase 14
# SEMANTIC_r05.json: the JAX package on one TPU v5e (accuracy, not speed)
SEMANTIC_R05 = {"iou_2d_high_touch": 0.9695, "iou_2d_low_touch": 0.9899,
                "voxel_iou_high_touch": 0.9754, "mutual_surface_voxels": 225941}
REPEATS = 20
# kernel vs plain: the same float32 operations in the same order (no FMA
# contraction, IEEE division); only the device's log/exp/log1p and the
# summation inside the rigid transform may differ by an ulp
TOL = {"tsdf": 2e-5, "weight": 2e-5, "prob": 2e-5, "minabs": 2e-5, "rgb": 1e-3}
# H100 SXM peaks, NVIDIA's data sheet (dense): device memory, int8 tensor
# cores, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# float32 operations of the fuse kernel (csrc/tsdf_fuse.cu), each log, log1p
# and exp counted as one: every voxel (sdf, the update gate, |tsdf| and the
# block min) and, on top, every updated voxel (the weighted averages, the
# log-odds, the clamps)
FUSE_OPS_PER_VOXEL = 8
FUSE_OPS_PER_UPDATE = 45
# scratch written before every timed call, so that each call finds the
# 50 MB L2 cold, as the main path does after a frame's other work
L2_FLUSH_BYTES = 256 * 2**20
_L2_SCRATCH = []


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def _flush_l2():
    """Write L2_FLUSH_BYTES of int16 scratch: an int16 fill, which
    neither kernel nor plain version launches, so `_device_ms` can leave
    it out by name."""
    if not _L2_SCRATCH:
        _L2_SCRATCH.append(torch.empty(L2_FLUSH_BYTES // 2, dtype=torch.int16, device="cuda"))
    _L2_SCRATCH[0].fill_(7)


def _median_ms(fn) -> float:
    """Median CUDA-event time of one call over REPEATS calls, each after
    an L2 flush outside its window. The flush also keeps the card busy
    while the host enqueues the call, so the window holds little host
    time."""
    fn()  # warm-up
    times = []
    for _ in range(REPEATS):
        _flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _cuda_events(fn):
    """The device events (torch.profiler) of everything `fn` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _device_ms(fn, only=""):
    """Mean device time per call, over REPEATS calls each after an L2
    flush (torch.profiler), of everything `fn` runs on the card (kernels
    and copies), and the mean time of one kernel whose name holds `only`
    (each call launches it once) with the number of its records: unlike
    the CUDA-event time it leaves out the gaps where the card waits on
    the host. On the card the profiler has dropped some of a kernel's
    records from a profile and shown others in a later profile, so the
    named time is a mean over the records that arrived, not a sum over
    the calls. The flush's own device events are left out."""
    flush = {e.name for e in _cuda_events(_flush_l2)}

    def calls():
        for _ in range(REPEATS):
            _flush_l2()
            fn()

    dev = _cuda_events(calls)
    mine = [e for e in dev if e.name not in flush]
    total = sum(e.time_range.elapsed_us() for e in mine)
    named = [e.time_range.elapsed_us() for e in mine if only and only in e.name]
    return total / 1e3 / REPEATS, (float(np.mean(named)) / 1e3 if named else float("nan")), len(named)


def _bound(nbytes, ops, ops_per_s):
    """(least time in ms, what bounds it): the bytes over the device
    memory's rate against the operations over their type's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _payload_copy(m):
    return dataclasses.replace(
        m, tsdf=m.tsdf.clone(), weight=m.weight.clone(), prob=m.prob.clone(), rgb=m.rgb.clone()
    )


def phase_kernel_vs_plain(dev, card):
    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.map import voxel_map as vm
    from ra_slam_tpu_torch.pipeline import offline_eval

    args = offline_eval.build_parser().parse_args(["--synthetic"])
    ds = offline_eval.load_dataset(args)
    cfg = offline_eval.system_config(ds.camera, args).tsdf
    cam = ds.camera
    stride = 2  # RaSlamSystem's allocation stride

    def frame(i):
        f = ds.frame(i)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return t(f.rgb), t(f.depth), t(f.ht), t(f.lt), SE3.from_matrix(t(f.cam_T_world))

    m = vm.create_map(cfg, dev)
    for i in range(FRAMES_BEFORE):
        rgb, depth, ht, lt, pose = frame(i)
        vm.integrate_frame(m, rgb, depth, ht, lt, cam, pose, cfg, alloc_stride=stride)

    rgb, depth, ht, lt, pose = frame(FRAMES_BEFORE)
    return _fuse_kernel_numbers(m, cfg, cam, (rgb, depth, ht, lt, pose),
                                lambda: vm.allocate_from_depth(m, depth, cam, pose, cfg, stride),
                                f"frame {FRAMES_BEFORE}", card)


def _fuse_kernel_numbers(m, cfg, cam, frame_args, allocate, label, card):
    """One more frame into map `m`: `allocate()`, cull and prep, then
    the fuse kernel against its plain version from the same state
    (fields within TOL, the same carve releases), their cold-L2 times,
    the kernel's bound and share of it, then the frame's carve. Returns
    the kernels line's numbers."""
    from ra_slam_tpu_torch.map import voxel_map as vm
    from ra_slam_tpu_torch.ops import tsdf_fuse

    rgb, depth, ht, lt, pose = frame_args
    H, W = depth.shape
    _, t_alloc = _event_ms(allocate)
    (vis_idx, vis_mask, count), t_cull = _event_ms(lambda: vm.visible_blocks(m, cam, pose, cfg))
    (pix, z, d2r, gate), t_prep = _event_ms(
        lambda: vm.integrate_prep(m, vis_idx, vis_mask, H, W, cam, pose, cfg)
    )
    img6 = vm.image_planes(rgb, depth, ht, lt)
    n_vis = int(count)
    if not 0 < n_vis <= cfg.max_visible_blocks:
        raise RuntimeError(f"visible blocks {n_vis} outside (0, {cfg.max_visible_blocks}]")
    fuse_args = (vis_idx, vis_mask, img6, pix, z, d2r, gate, cfg)

    mk, mp = _payload_copy(m), _payload_copy(m)
    minabs_k = tsdf_fuse.tsdf_fuse_(mk, *fuse_args)
    minabs_p = tsdf_fuse.tsdf_fuse_plain_(mp, *fuse_args)
    torch.cuda.synchronize()
    err = {
        name: (getattr(mk, name) - getattr(mp, name)).abs().max().item()
        for name in ("tsdf", "weight", "prob", "rgb")
    }
    err["minabs"] = (minabs_k - minabs_p)[vis_mask].abs().max().item()
    print("kernel vs plain max |diff|:", json.dumps(err))
    for name, bound in TOL.items():
        if not err[name] <= bound:
            raise AssertionError(f"tsdf_fuse kernel vs plain: {name} differs by {err[name]} > {bound}")
    if (minabs_k[~vis_mask] != 0).any():
        raise AssertionError("kernel wrote minabs of a masked slot")
    rel_k = vis_mask & (minabs_k >= cfg.carve_threshold)
    rel_p = vis_mask & (minabs_p >= cfg.carve_threshold)
    if not torch.equal(rel_k, rel_p):
        raise AssertionError("kernel and plain release different blocks")
    updated = (mk.weight[vis_idx[vis_mask].long()] != m.weight[vis_idx[vis_mask].long()]).sum().item()
    if updated == 0:
        raise AssertionError("the frame updated no voxel")

    kernel = lambda: tsdf_fuse.tsdf_fuse_(mk, *fuse_args)
    plain = lambda: tsdf_fuse.tsdf_fuse_plain_(mp, *fuse_args)
    ms, plain_ms = _median_ms(kernel), _median_ms(plain)
    (dev_ms, kernel_ms, n_rec), (plain_dev_ms, _, _) = _device_ms(kernel, "tsdf_fuse"), _device_ms(plain)
    del mk, mp
    _, t_carve = _event_ms(lambda: vm.integrate(m, *fuse_args[:2], rgb, depth, ht, lt, cam, pose, cfg, carve=True))
    # the least device-memory traffic of the kernel: per voxel the pool
    # state (6 x 4 B) and the prep (pix, z, d2r, gate: 4 x 4 B) read once,
    # the image read once, the pool state of updated voxels written once
    min_bytes = n_vis * 512 * 40 + img6.numel() * 4 + updated * 24
    ops = n_vis * 512 * FUSE_OPS_PER_VOXEL + updated * FUSE_OPS_PER_UPDATE
    bound_ms, bound_by = _bound(min_bytes, ops, F32_FLOPS_PER_S)
    print(
        f"tsdf_fuse at {label}: {n_vis} visible blocks ({n_vis * 512} voxels, "
        f"{int(rel_k.sum())} released, {updated} voxels updated), each call after a "
        f"{L2_FLUSH_BYTES >> 20} MiB L2 flush: per call (median of {REPEATS}, CUDA events, index "
        f"validation included): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; device time per call "
        f"(torch.profiler, mean): kernel call {dev_ms:.4f} ms of which the kernel "
        f"{kernel_ms:.4f} ms ({n_rec} of {REPEATS} launches recorded), plain {plain_dev_ms:.4f} ms; kernel moves >= "
        f"{min_bytes / 1e6:.1f} MB = {min_bytes / (kernel_ms / 1e3) / 1e9:.1f} GB/s, "
        f"{ops / 1e6:.1f} M float32 ops; bound {bound_ms:.4f} ms ({bound_by}), share of the bound "
        f"{bound_ms / kernel_ms:.3f} (kernel device time), {bound_ms / ms:.3f} (per call); {card}"
    )
    print(
        f"one frame by stage (ms, single run): allocate {t_alloc:.3f}, cull {t_cull:.3f}, "
        f"prep {t_prep:.3f}, integrate (prep+fuse+carve) {t_carve:.3f}; {card}"
    )
    return {"max_abs_err": max(err.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _walls(rows):
    """The surface voxels (|tsdf| < 0.2) of a tsdf.bin's rows, their
    distance to the synthetic room's walls, the mask of those on its +x
    wall and the mean prob there and on the other walls. The room is the
    box |x| <= 3, |y| <= 2, |z| <= 3 m; its +x wall is the high-touch
    class (p = 0.95, the other walls 0.05). Raises on values outside
    tsdf [-1, 1] / prob [0, 1]."""
    tsdf, prob = rows[:, 3], rows[:, 4]
    if not (np.isfinite(rows).all() and (np.abs(tsdf) <= 1).all() and ((prob >= 0) & (prob <= 1)).all()):
        raise AssertionError("tsdf.bin holds values outside tsdf [-1, 1] / prob [0, 1]")
    surf = rows[np.abs(tsdf) < 0.2]
    x, y, zz = np.abs(surf[:, 0]), np.abs(surf[:, 1]), np.abs(surf[:, 2])
    dist = np.abs(np.minimum(np.minimum(3.0 - x, 2.0 - y), 3.0 - zz))
    near_ht = surf[:, 0] > 2.95
    return surf, dist, near_ht, surf[near_ht, 4].mean(), surf[surf[:, 0] < 2.9, 4].mean()


class _MeshCall:
    """Wraps `RaSlamSystem.download_all_mesh` while entered: the wall
    time of its call (extraction and the three file writes) and the
    system it was called on."""

    def __enter__(self):
        from ra_slam_tpu_torch.pipeline.system import RaSlamSystem

        self.cls, self.saved = RaSlamSystem, RaSlamSystem.download_all_mesh

        def timed(system, *paths):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.saved(system, *paths)
            self.seconds, self.system = time.perf_counter() - t0, system
            return out

        RaSlamSystem.download_all_mesh = timed
        return self

    def __exit__(self, *exc):
        self.cls.download_all_mesh = self.saved


def phase_main_path(card):
    from ra_slam_tpu_torch.map.meshing import extract_mesh
    from ra_slam_tpu_torch.ops import tsdf_fuse
    from ra_slam_tpu_torch.pipeline import offline_eval

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, _MeshCall() as mesh_call:
        tsdf_fuse.LAUNCHES = 0
        r = offline_eval.main(
            ["--synthetic", "--max-frames", str(MAIN_FRAMES), "--download", tmp]
        )
        launches = tsdf_fuse.LAUNCHES
        rows = np.fromfile(os.path.join(tmp, "tsdf.bin"), "<f4").reshape(-1, 5)
        verts = np.fromfile(os.path.join(tmp, "mesh_vertices.bin"), "<f4").reshape(-1, 3)
        tris = np.fromfile(os.path.join(tmp, "mesh_indices.bin"), "<i4").reshape(-1, 3)
        vprob = np.fromfile(os.path.join(tmp, "mesh_vertices_prob.bin"), "<f4")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    system = mesh_call.system

    if r["frames"] != MAIN_FRAMES:
        raise AssertionError(f"fused {r['frames']} of {MAIN_FRAMES} frames")
    if r["alloc_failures"] != 0 or r["num_active"] <= 0:
        raise AssertionError(f"allocation: {r}")
    if launches < MAIN_FRAMES:
        raise AssertionError(f"the main path launched the kernel {launches} times")
    if r["tsdf_rows"] <= 0 or len(rows) != r["tsdf_rows"]:
        raise AssertionError(f"tsdf.bin holds {len(rows)} rows, the run reported {r['tsdf_rows']}")
    surf, dist, near_ht, p_ht, p_lt = _walls(rows)
    print(
        f"surface voxels {len(surf)}: distance to the room's walls median "
        f"{np.median(dist):.4f} m, p99 {np.quantile(dist, 0.99):.4f} m; "
        f"mean prob +x wall {p_ht:.3f}, other walls {p_lt:.3f}"
    )
    if not (np.median(dist) < 0.015 and np.quantile(dist, 0.99) < 0.05):
        raise AssertionError("fused surface is not on the room's walls")
    if not (near_ht.sum() > 0 and p_ht > 0.8 and p_lt < 0.2):
        raise AssertionError("fused semantics do not follow the high-touch wall")

    print(
        f"main path: {r['frames']} frames, {r['fps']} fused frames/s end to end "
        f"(incl. host rendering of the synthetic frames; the dumps come after), "
        f"{r['frames'] / r['integrate_s']:.2f} frames/s inside feed_rgbd_frame; "
        f"{r['num_active']} active blocks, {r['tsdf_rows']} voxels dumped, "
        f"{launches} kernel launches, peak device memory {peak_gb:.2f} GiB; {card}"
    )

    # the mesh: counts, indices, the walls, the high-touch wall
    nv, nt = r["mesh_vertices"], r["mesh_triangles"]
    if not (len(verts) == nv == len(vprob) and len(tris) == nt and nt > 0):
        raise AssertionError(f"mesh dumps hold {len(verts)} / {len(tris)} / {len(vprob)}, the run reported {nv} / {nt}")
    if not (tris.min() >= 0 and tris.max() < nv):
        raise AssertionError("mesh index out of range")
    if ((tris[:, 0] == tris[:, 1]) | (tris[:, 1] == tris[:, 2]) | (tris[:, 0] == tris[:, 2])).any():
        raise AssertionError("degenerate mesh triangle")
    wall_d = np.min(np.abs(np.abs(verts) - np.array([3.0, 2.0, 3.0])[None]), axis=1)
    p95 = float(np.percentile(wall_d, 95))
    ht_wall = verts[:, 0] > 2.95
    p_ht_mesh = float(vprob[ht_wall].mean()) if ht_wall.any() else float("nan")
    cfg = system.cfg.tsdf
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        v2, i2, p2 = extract_mesh(system.map, cfg)
        warm.append(time.perf_counter() - t0)
        mesh_gb = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    if not (np.array_equal(i2, tris) and np.array_equal(v2, verts) and np.array_equal(p2, vprob)):
        raise AssertionError("a second extraction of the same map differs")
    print(
        f"mesh of the main path's map: {nt} triangles, {nv} vertices; vertex distance to the walls "
        f"p95 {p95:.5f} m (bound {2 * cfg.voxel_size} m), mean vertex prob +x wall {p_ht_mesh:.4f} "
        f"({int(ht_wall.sum())} vertices); extraction wall time (extract_mesh, numpy out): cold "
        f"{mesh_call.seconds:.3f} s (first call in the process, in the CLI, with the three file writes), "
        f"warm {float(np.median(warm)):.3f} s (median of 3: {', '.join(f'{t:.3f}' for t in warm)}); "
        f"peak device memory of one extraction above the map {mesh_gb:.2f} GiB; {card}"
    )
    if not p95 < 2 * cfg.voxel_size:
        raise AssertionError(f"mesh vertices p95 {p95} m from the walls")
    if not p_ht_mesh > 0.8:
        raise AssertionError(f"mesh vertex prob on the high-touch wall {p_ht_mesh}")
    return launches, system


def phase_raycast(system, card):
    """3b: the facade's render at the main path's 60 orbit poses."""
    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.pipeline import offline_eval

    ds = offline_eval.load_dataset(offline_eval.build_parser().parse_args(["--synthetic"]))
    cfg = system.cfg.tsdf
    poses = [np.linalg.inv(ds.world_T_cam(i).astype(np.float64)).astype(np.float32)
             for i in range(MAIN_FRAMES)]
    system.render(SE3.from_matrix(torch.as_tensor(poses[1])))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    times, dropped, hits = [], [], []
    for p in poses:
        out, ms = _event_ms(lambda: system.render(SE3.from_matrix(torch.as_tensor(p))))
        times.append(ms)
        dropped.append(int(out["dropped_splats"]))
        hits.append(float(out["hit"].float().mean()))
        if len(times) == 1:
            depth0, hit0 = out["depth"].cpu().numpy(), out["hit"].cpu().numpy()
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    gt = ds.frame(0).depth
    sel = hit0 & (gt > 0)
    rmse = float(np.sqrt(np.mean((depth0[sel] - gt[sel]) ** 2)))
    total_s = sum(times) / 1e3
    print(
        f"raycast sweep: {len(poses)} VGA renders of the main path's map (RaSlamSystem.render), "
        f"{len(poses) / total_s:.2f} renders/s (CUDA events around each render: median "
        f"{float(np.median(times)):.3f} ms, min {min(times):.3f}, max {max(times):.3f}), hit share "
        f"{min(hits):.3f}-{max(hits):.3f}, dropped splats max {max(dropped)}; frame 0 against the "
        f"analytic depth: coverage {sel.mean():.4f}, RMSE {rmse:.5f} m (bound {3 * cfg.voxel_size} m); "
        f"peak device memory of a render above the map {peak_gb:.3f} GiB; {card}"
    )
    if max(dropped) != 0:
        raise AssertionError(f"raycast dropped shell blocks: {dropped}")
    if not (sel.mean() > 0.7 and rmse < 3 * cfg.voxel_size):
        raise AssertionError(f"raycast depth: coverage {sel.mean()}, RMSE {rmse} m")


def phase_readers_device_vs_cpu(dev, card):
    """3c: meshing and raycast of one map on the card and on the CPU."""
    from ra_slam_tpu_torch.core.config import TsdfConfig
    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.map.meshing import extract_mesh
    from ra_slam_tpu_torch.map.raycast import raycast
    from ra_slam_tpu_torch.map.synthetic_map import analytic_box_map
    from ra_slam_tpu_torch.pipeline import offline_eval

    ds = offline_eval.load_dataset(offline_eval.build_parser().parse_args(["--synthetic"]))
    cfg = TsdfConfig(voxel_size=0.04, truncation=0.12, log2_num_blocks=14, log2_hash_size=16,
                     max_visible_blocks=1 << 14, width=640, height=480)
    maps = {}
    for d in ("cpu", dev):
        m = analytic_box_map(cfg, d)
        # colour and probability fields that vary, the same on both devices
        x = torch.arange(512, device=m.device)
        act = m.active[:, None]
        m.prob.copy_(torch.where(act, (x % 97).to(torch.float32) / 96.0, m.prob))
        for c in range(3):
            m.rgb[:, c].copy_(torch.where(act, ((x * (7 + c)) % 256).to(torch.float32), m.rgb[:, c]))
        maps[str(d)] = m
    n_blocks = int(maps["cpu"].active.sum())
    (cv, ci, cp) = extract_mesh(maps["cpu"], cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gv, gi, gp = extract_mesh(maps[str(dev)], cfg)
    mesh_s = time.perf_counter() - t0
    if not (ci.shape == gi.shape and cv.shape == gv.shape and np.array_equal(ci, gi)):
        raise AssertionError(f"mesh card vs CPU: {gi.shape} / {ci.shape} triangles, indices differ")
    v_steps = float((np.abs(cv - gv) / ((cv.max(0) - cv.min(0)) / 65535.0)).max())
    p_steps = float(np.abs(cp - gp).max() * 65535.0)

    pose = np.linalg.inv(ds.world_T_cam(0).astype(np.float64)).astype(np.float32)
    out = {}
    for d, m in maps.items():
        out[d] = {k: v.cpu().numpy() for k, v in raycast(
            m, ds.camera, SE3.from_matrix(torch.as_tensor(pose, device=m.device)), cfg).items()}
    c, g = out["cpu"], out[str(dev)]
    dz = np.abs(c["depth"] - g["depth"])
    flipped = dz > 1e-5
    near = flipped.copy()
    for ax in (0, 1):
        for sh in (-1, 1):
            near |= np.roll(flipped, sh, axis=ax)
    n_err = float(np.abs(c["normal"] - g["normal"])[~near].max())
    c_err = float(np.abs(c["rgba"] - g["rgba"])[~near].max())
    zstep = (cfg.max_depth - cfg.min_depth) / 8191
    print(
        f"readers card vs CPU (analytic room at {cfg.voxel_size} m, {n_blocks} blocks): mesh {len(gi)} "
        f"triangles, {len(gv)} vertices, indices equal; vertices within {v_steps:.3f} u16 steps, probs "
        f"within {p_steps:.3f} (bound 1); card extraction {mesh_s:.3f} s; render at frame 0's pose: "
        f"{int(c['hit'].sum())} hits, hit masks equal {np.array_equal(c['hit'], g['hit'])}, depth "
        f"max |diff| {float(dz.max()):.3g} m, {int(flipped.sum())} pixels swapped winners (bound "
        f"{1e-3 * c['hit'].sum():.0f}), normal {n_err:.3g} (bound 1e-5), rgba {c_err:.3g} (bound 1e-3) "
        f"elsewhere; {card}"
    )
    if not (v_steps <= 1.001 and p_steps <= 1.001):
        raise AssertionError(f"mesh card vs CPU: {v_steps} / {p_steps} u16 steps")
    if not (np.array_equal(c["hit"], g["hit"]) and int(c["dropped_splats"]) == int(g["dropped_splats"])):
        raise AssertionError("raycast card vs CPU: hit masks or dropped counts differ")
    if not (flipped.sum() <= 1e-3 * c["hit"].sum() and dz.max() <= zstep + 1e-5):
        raise AssertionError(f"raycast card vs CPU: {int(flipped.sum())} swapped, depth {dz.max()}")
    if not (n_err <= 1e-5 and c_err <= 1e-3):
        raise AssertionError(f"raycast card vs CPU: normal {n_err}, rgba {c_err}")


def probe_decoders():
    """Phase 1: the JPEG decoders this machine has, and two Python
    packages the port could have used and does not."""
    import importlib.util

    from ra_slam_tpu_torch.io import jpeg

    found = jpeg.probe()
    specs = {name: importlib.util.find_spec(name) is not None for name in ("torchvision", "msgpack")}
    print(f"JPEG decoder probe: {json.dumps(found)}; importable: {json.dumps(specs)}")
    return found


def phase_fusion_device_vs_cpu(dev, card):
    """2b: the main path's configuration (VGA, 1 cm voxels, 2^17 blocks,
    2^19 slots, 16384 visible / 32768 new blocks, stride 2) fused over the
    orbit's first frames on the card and on the CPU: keys, the hash
    table, the free stack and the stats exactly equal, the payload within
    TOL."""
    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.map import voxel_map as vm
    from ra_slam_tpu_torch.pipeline import offline_eval
    from ra_slam_tpu_torch.utils.convert import voxel_map_to_numpy

    args = offline_eval.build_parser().parse_args(["--synthetic"])
    ds = offline_eval.load_dataset(args)
    cfg = offline_eval.system_config(ds.camera, args).tsdf
    maps = {"cpu": vm.create_map(cfg, "cpu"), "cuda": vm.create_map(cfg, dev)}
    secs = {"cpu": 0.0, "cuda": 0.0}
    for i in range(DEV_VS_CPU_FRAMES):
        f = ds.frame(i)
        stats = {}
        for name, m in maps.items():
            t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=m.device)
            t0 = time.perf_counter()
            _, st = vm.integrate_frame(m, t(f.rgb), t(f.depth), t(f.ht), t(f.lt), ds.camera,
                                       SE3.from_matrix(t(f.cam_T_world)), cfg, alloc_stride=2)
            stats[name] = {k: int(v) for k, v in st.items()}
            secs[name] += time.perf_counter() - t0
        if stats["cpu"] != stats["cuda"]:
            raise AssertionError(f"fusion card vs CPU: frame {i} stats {stats}")
    c, g = voxel_map_to_numpy(maps["cpu"]), voxel_map_to_numpy(maps["cuda"])
    differ = {name: int((getattr(c, name) != getattr(g, name)).sum())
              for name in ("block_key", "block_slot", "active", "free_stack", "free_top", "alloc_failures")}
    differ["table.key"] = int((c.table.key != g.table.key).sum())
    differ["table.value"] = int((c.table.value != g.table.value).sum())
    err = {name: float(np.abs(getattr(c, name) - getattr(g, name)).max()) for name in ("tsdf", "weight", "prob", "rgb")}
    print(
        f"fusion card vs CPU at the main path's configuration ({DEV_VS_CPU_FRAMES} VGA frames, "
        f"{int(c.active.sum())} active blocks, last frame {stats['cpu']}): entries that differ "
        f"{json.dumps(differ)}; payload max |diff| {json.dumps(err)} (bounds {json.dumps(TOL)}); "
        f"CPU {secs['cpu']:.2f} s, card {secs['cuda']:.2f} s; {card}"
    )
    if any(differ.values()):
        raise AssertionError(f"fusion card vs CPU: map entries differ {differ}")
    for name, e in err.items():
        if not e <= TOL[name]:
            raise AssertionError(f"fusion card vs CPU: {name} differs by {e} > {TOL[name]}")


class _Timed:
    """While entered, wraps `owner.<name>` so that every call is timed:
    CUDA events (`cuda=True`, read after a sync) or the host clock."""

    def __init__(self, owner, name, cuda):
        self.owner, self.name, self.cuda, self.records = owner, name, cuda, []

    def __enter__(self):
        self.saved = getattr(self.owner, self.name)
        saved, records, cuda = self.saved, self.records, self.cuda

        def timed(*args, **kwargs):
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = saved(*args, **kwargs)
                end.record()
                records.append((start, end))
            else:
                t0 = time.perf_counter()
                out = saved(*args, **kwargs)
                records.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.saved)

    def ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) for s, e in self.records]
        return list(self.records)


def _check_recorded(r, rows, n, launches, name):
    surf, dist, _, _, _ = _walls(rows)
    if r["frames"] != n or launches < n:
        raise AssertionError(f"{name}: fused {r['frames']} of {n} frames, {launches} fuse launches")
    if r["alloc_failures"] != 0 or len(rows) != r["tsdf_rows"]:
        raise AssertionError(f"{name}: {r}")
    if not (np.median(dist) <= 0.015 and np.quantile(dist, 0.99) <= 0.05):
        raise AssertionError(f"{name}: the fused surface is not on the room's walls")
    return float(np.median(dist)), float(np.quantile(dist, 0.99))


def phase_recorded_folder(dev, card):
    """3d: the recorded-data main path: 60 VGA orbit frames logged by the
    port's folder writer without maps, segmented by the default-width
    UNet from a checkpoint the port saves, fused on the card by
    `offline_eval --folder --model`."""
    from ra_slam_tpu_torch.io import folder as folder_io
    from ra_slam_tpu_torch.models import segmentation as seg
    from ra_slam_tpu_torch.ops import tsdf_fuse
    from ra_slam_tpu_torch.pipeline import offline_eval

    ds = offline_eval.load_dataset(offline_eval.build_parser().parse_args(["--synthetic"]))
    with tempfile.TemporaryDirectory() as tmp:
        rec, ckpt, out = (os.path.join(tmp, n) for n in ("rec", "seg.msgpack", "out"))
        t0 = time.perf_counter()
        folder_io.write_folder_dataset(
            rec, [dataclasses.replace(ds.frame(i), ht=None, lt=None) for i in range(MAIN_FRAMES)], ds.camera)
        write_s = time.perf_counter() - t0
        seg.InferenceEngine("__random__", 640, 480, device=dev).save(ckpt)
        torch.cuda.reset_peak_memory_stats()
        with _Timed(seg.InferenceEngine, "forward", True) as fwd, \
                _Timed(seg.InferenceEngine, "segment", True) as segm, \
                _Timed(folder_io, "read_png", False) as png_read:
            tsdf_fuse.LAUNCHES = 0
            r = offline_eval.main(["--folder", rec, "--model", ckpt, "--max-frames", str(MAIN_FRAMES),
                                   "--download", out])
            launches = tsdf_fuse.LAUNCHES
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        rows = np.fromfile(os.path.join(out, "tsdf.bin"), "<f4").reshape(-1, 5)
        engine = seg.InferenceEngine(ckpt, 640, 480, device=dev)
        rgb = ds.frame(0).rgb
        engine.infer_one(rgb)
        infer_ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            engine.infer_one(rgb)
            infer_ms.append((time.perf_counter() - t0) * 1e3)
    med, p99 = _check_recorded(r, rows, MAIN_FRAMES, launches, "recorded folder path")
    fwd_ms, seg_ms, png_ms = fwd.ms()[1:], segm.ms()[1:], png_read.ms()
    # the first read is the reader's size probe, then depth and colour per frame
    depth_ms, rgb_ms = png_ms[1::2], png_ms[2::2]
    if len(fwd_ms) != MAIN_FRAMES - 1:
        raise AssertionError(f"the UNet ran {len(fwd_ms) + 1} times for {MAIN_FRAMES} frames")
    print(
        f"recorded folder path (offline_eval --folder --model, default-width UNet, random weights): "
        f"{r['frames']} VGA frames, {r['fps']} fused frames/s end to end (PNG decode and segmentation "
        f"included), {r['frames'] / r['integrate_s']:.2f} frames/s inside feed_rgbd_frame; UNet per frame "
        f"(CUDA events, median of frames 1..{MAIN_FRAMES - 1}): forward {float(np.median(fwd_ms)):.3f} ms, "
        f"segment (pad, forward, softmax, crop) {float(np.median(seg_ms)):.3f} ms; infer_one with its host "
        f"round trip (host clock, median of 20) {float(np.median(infer_ms)):.3f} ms; PNG decode per frame "
        f"{float(np.median(np.add(rgb_ms, depth_ms))):.2f} ms (VGA RGB {float(np.median(rgb_ms)):.2f} ms, "
        f"16-bit depth {float(np.median(depth_ms)):.2f} ms, median); writing the folder {write_s:.2f} s; "
        f"{launches} fuse launches, alloc_failures {r['alloc_failures']}, {r['tsdf_rows']} voxels dumped, "
        f"wall distance median {med:.5f} m, p99 {p99:.5f} m, prob in [0, 1]; peak device memory "
        f"{peak_gb:.2f} GiB; {card}"
    )
    return launches


def _scannet_like_sens(path, ds, n):
    """A .sens of the orbit's first `n` frames as ScanNet lays one out:
    PNG colour at 1296x968 (the orbit rendered at that size), 16-bit
    depth in mm at 640x480, the depth camera's intrinsics."""
    from ra_slam_tpu_torch.io.sens import write_sens
    from ra_slam_tpu_torch.io.synthetic import SyntheticCameraSpec, render_box_room

    cw, ch = SCANNET_COLOR
    sx, sy = cw / ds.spec.width, ch / ds.spec.height
    spec = ds.spec
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


def phase_recorded_sens(dev, card, decoders):
    """3e: `offline_eval --sens` over a ScanNet-shaped file the port
    writes (colour resized to the depth size on read), then phase 15
    (`--native-io`) over the same file; then, with nvjpeg, the JPEG
    fixture against cv2's pixels. Returns the two runs' fuse launches."""
    from ra_slam_tpu_torch.io import sens as sens_io
    from ra_slam_tpu_torch.ops import tsdf_fuse
    from ra_slam_tpu_torch.pipeline import offline_eval

    ds = offline_eval.load_dataset(offline_eval.build_parser().parse_args(["--synthetic"]))
    with tempfile.TemporaryDirectory() as tmp:
        path, out = os.path.join(tmp, "scene.sens"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        _scannet_like_sens(path, ds, SENS_FRAMES)
        write_s = time.perf_counter() - t0
        with _Timed(sens_io.SensReader, "frame", False) as read:
            tsdf_fuse.LAUNCHES = 0
            r = offline_eval.main(["--sens", path, "--max-frames", str(SENS_FRAMES), "--download", out])
            launches = tsdf_fuse.LAUNCHES
        rows = np.fromfile(os.path.join(out, "tsdf.bin"), "<f4").reshape(-1, 5)
        size_mb = os.path.getsize(path) / 1e6
        med, p99 = _check_recorded(r, rows, SENS_FRAMES, launches, ".sens path")
        print(
            f".sens path (offline_eval --sens, PNG colour {SCANNET_COLOR[0]}x{SCANNET_COLOR[1]} resized to 640x480, "
            f"zlib depth, fake maps): {r['frames']} frames, {r['fps']} fused frames/s end to end, "
            f"{r['frames'] / r['integrate_s']:.2f} frames/s inside feed_rgbd_frame; SensReader.frame (PNG "
            f"decode, inflate, colour resize on the CPU) median {float(np.median(read.ms())):.1f} ms; file "
            f"{size_mb:.1f} MB written in {write_s:.2f} s; {launches} fuse launches, wall distance median "
            f"{med:.5f} m, p99 {p99:.5f} m; {card}"
        )
        t0 = time.perf_counter()
        native_launches = phase_native_io(path, r, rows, card)
        print(f"phase 15 wall time {time.perf_counter() - t0:.2f} s")
    if decoders.get("nvjpeg") or decoders.get("nvjpeg (CUDA toolkit)"):
        from ra_slam_tpu_torch.io import jpeg

        reader = sens_io.SensReader(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                 "tests", "data", "jpeg_64x48.sens"))
        want = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                                    "jpeg_64x48_rgb.npy")).astype(np.int32)
        got = np.stack([reader.frame(i).rgb for i in range(len(reader))]).astype(np.int32)
        reader.close()
        d = np.abs(got - want)
        per_frame = [(int(x.max()), round(float(x.mean()), 3)) for x in d]
        print(f"JPEG fixture through {jpeg.decoder_name()} against cv2's pixels: {got.shape}, max |diff| "
              f"{int(d.max())} levels, mean {float(d.mean()):.3f} (per frame (max, mean): {per_frame}), "
              f"{float((d > 0).mean()):.4f} of the values differ (bounds {JPEG_MAX_TOL} / {JPEG_MEAN_TOL}); {card}")
        if got.shape != want.shape or d.max() > JPEG_MAX_TOL or d.mean() > JPEG_MEAN_TOL:
            raise AssertionError("nvjpeg against cv2 on the JPEG fixture outside the bounds")
    return launches, native_launches


def _seg_card_vs_cpu(dev, model, widths, rgbs):
    """(prob max |diff|, flipped share, share of pixels within
    SEG_PROB_TOL of 0.5 on the CPU, flips outside that band) of the ht
    maps of `rgbs` on the card against the CPU, the same weights."""
    from ra_slam_tpu_torch.models.segmentation import InferenceEngine

    h, w = rgbs[0].shape[:2]
    engines = {d: InferenceEngine(model, w, h, widths=widths, device=d) for d in ("cpu", dev)}
    c, g = (np.stack([engines[d].segment(torch.as_tensor(x))[0].cpu().numpy() for x in rgbs]) for d in ("cpu", dev))
    flipped = (c > 0.5) != (g > 0.5)
    band = np.abs(c - 0.5) <= SEG_PROB_TOL
    return float(np.abs(c - g).max()), float(flipped.mean()), float(band.mean()), int((flipped & ~band).sum())


def phase_unet_resize_device_vs_cpu(dev, card):
    """3f: the UNet on the card against the CPU, TF32 off: the
    default-width net (random weights) on one VGA frame, and the trained
    (16, 32, 64) weights on two held-out 320x240 frames (the set the
    CPU-vs-JAX bounds were measured on); the resizes on the card against
    the CPU, exactly."""
    from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
    from ra_slam_tpu_torch.ops.resize import resize
    from ra_slam_tpu_torch.pipeline import offline_eval

    here = os.path.dirname(os.path.abspath(__file__))
    ds = offline_eval.load_dataset(offline_eval.build_parser().parse_args(["--synthetic"]))
    dp, flips, band, out_of_band = _seg_card_vs_cpu(dev, "__random__", (32, 64, 128, 256), [ds.frame(0).rgb])
    held = SyntheticBoxDataset(num_frames=16, cam=SyntheticCameraSpec(fx=160.0, fy=160.0, cx=159.5, cy=119.5,
                                                                       width=320, height=240),
                               radius=1.0, seed=3, clutter=4)
    tp, tflips, tband, t_out = _seg_card_vs_cpu(dev, os.path.join(here, "ra_slam_tpu", "models", "demo_seg.msgpack"),
                                                (16, 32, 64), [held.frame(i).rgb for i in (0, 1)])
    rng = np.random.default_rng(0)
    cases = {
        "uint8 RGB 1296x968 -> 640x480 linear": (rng.integers(0, 256, (968, 1296, 3), dtype=np.uint8), 640, 480, "linear"),
        "uint8 RGB 320x240 -> 640x480 linear": (rng.integers(0, 256, (240, 320, 3), dtype=np.uint8), 640, 480, "linear"),
        "float32 50x35 -> 640x480 linear": (rng.random((35, 50)).astype(np.float32), 640, 480, "linear"),
        "depth 1296x968 -> 640x480 nearest": (rng.random((968, 1296)).astype(np.float32), 640, 480, "nearest"),
    }
    same = {}
    for name, (img, w, h, how) in cases.items():
        a = resize(torch.as_tensor(img), w, h, how)
        b = resize(torch.as_tensor(img, device=dev), w, h, how).cpu()
        same[name] = bool(torch.equal(a, b))
    print(
        f"UNet card vs CPU (bf16, TF32 off): default widths, random weights seed 0, one VGA frame: ht prob "
        f"max |diff| {dp:.5f} (bound {SEG_PROB_TOL}), flipped prob > 0.5 decisions {flips:.6f} of the pixels, "
        f"all where the CPU's prob is within {SEG_PROB_TOL} of 0.5 ({band:.6f} of the pixels; {out_of_band} "
        f"flips outside); trained (16, 32, 64) weights, two held-out 320x240 frames: prob max |diff| {tp:.5f}, "
        f"flipped {tflips:.6f} (bound {SEG_FLIP_SHARE}), {t_out} outside the band; resize card == CPU: "
        f"{json.dumps(same)}; {card}"
    )
    if not (dp <= SEG_PROB_TOL and out_of_band == 0 and tp <= SEG_PROB_TOL and tflips <= SEG_FLIP_SHARE
            and t_out == 0):
        raise AssertionError("UNet card vs CPU outside the bounds")
    if not all(same.values()):
        raise AssertionError(f"resize card vs CPU differ: {same}")


def phase_seg_latency(dev, card):
    """3g: the latency CLI at VGA, default widths, and the forward alone
    against its bound (the convolutions' operations over the bf16 dense
    peak)."""
    from ra_slam_tpu_torch.models import segmentation as seg

    r = seg._bench(["--iters", str(SEG_ITERS), "--device", "cuda"])
    eng = seg.InferenceEngine("__random__", 640, 480, device=dev)
    x = torch.rand((1, 3, 480, 640), generator=torch.Generator().manual_seed(0)).to(dev)
    ms = _median_ms(lambda: eng.forward(x))
    dev_ms, _, _ = _device_ms(lambda: eng.forward(x))
    flops = seg.forward_flops(seg.DEFAULT_WIDTHS, 480, 640)
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    print(
        f"segmentation latency CLI (--iters {SEG_ITERS}, VGA, default widths): {r['value']} ms per infer_one "
        f"({r['fps']} f/s, host round trip included), backend {r['backend']}; the forward alone, each call "
        f"after a {L2_FLUSH_BYTES >> 20} MiB L2 flush: {ms:.3f} ms per call (median of {REPEATS}, CUDA "
        f"events), device time {dev_ms:.3f} ms (torch.profiler, mean); {flops / 1e9:.1f} GFLOP per forward, "
        f"bound {bound_ms:.4f} ms (operations, bf16 dense peak), share of the bound {bound_ms / dev_ms:.3f} "
        f"(device time), {bound_ms / ms:.3f} (per call); {card}"
    )


def phase_rescore(card):
    """3h: scripts/score_torch_semantic.py on the card and on this
    machine's CPU, beside SEMANTIC_r05.json's JAX-on-TPU numbers."""
    mod = _load_script("score_torch_semantic")
    gpu, cpu = mod.score("cuda"), mod.score("cpu")
    print(f"re-score of demo_seg.msgpack through the port: card {json.dumps(gpu)}; CPU {json.dumps(cpu)}; "
          f"SEMANTIC_r05.json (the JAX package on a TPU) {json.dumps(SEMANTIC_R05)}; {card}")
    for key in ("iou_2d_high_touch", "iou_2d_low_touch", "voxel_iou_high_touch"):
        if not abs(gpu[key] - cpu[key]) <= RESCORE_TOL:
            raise AssertionError(f"re-score {key}: card {gpu[key]}, CPU {cpu[key]}")


def _load_script(name):
    """A module of scripts/ by file path (scripts/ is no package)."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(name, os.path.join(here, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_training(dev, card):
    """11: scripts/train_torch_semantic.py on the card from the committed
    JAX init, 300 steps; the trained weights scored by
    scripts/score_torch_semantic.py --weights; one float32 training step
    (TF32 off) on the card and on the CPU from the same parameters and
    batch, the gradients compared per tensor."""
    from ra_slam_tpu_torch.models.segmentation import make_train_step, masked_cross_entropy

    trainer, scorer = _load_script("train_torch_semantic"), _load_script("score_torch_semantic")
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "seg.msgpack")
        r = trainer.main(["--out", weights, "--device", "cuda"])
        sc = scorer.main(["--weights", weights, "--device", "cuda"])
    first, last = r["train_loss_first_last"]

    x, y = trainer.batch_arrays(trainer.frames(seed=0, n=trainer.BATCH))
    grads, losses = {}, {}
    for d in ("cpu", dev):
        net = trainer.load_net(trainer.INIT, dtype=torch.float32).to(d)
        step = make_train_step(net, torch.optim.Adam(net.parameters(), lr=trainer.LR))
        losses[str(d)] = float(step(torch.as_tensor(x, device=d), torch.as_tensor(y, device=d)))
        grads[str(d)] = {n: p.grad.detach().cpu() for n, p in net.named_parameters()}
    # the control: the same gradients on the card with cuDNN's TF32 on
    net = trainer.load_net(trainer.INIT, dtype=torch.float32).to(dev)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        masked_cross_entropy(net(torch.as_tensor(x, device=dev)), torch.as_tensor(y, device=dev)).backward()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    grads["tf32"] = {n: p.grad.detach().cpu() for n, p in net.named_parameters()}
    rel, rel_tf32 = ({n: float((grads[k][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                      for n, g in grads["cpu"].items()} for k in (str(dev), "tf32"))
    worst, worst_tf32 = max(rel, key=rel.get), max(rel_tf32, key=rel_tf32.get)
    print(
        f"training (scripts/train_torch_semantic.py, (16, 32, 64) net from the committed JAX init, "
        f"{r['train_steps']} Adam steps of batch {trainer.BATCH} at 256x320, bf16 forward): loss {first:.4f} -> "
        f"{last:.4f} (SEMANTIC_r05.json, JAX on a TPU: 0.6504 -> 0.0352; gates |first - 0.6504| <= "
        f"{TRAIN_FIRST_TOL}, last < {TRAIN_LAST_BOUND}), {r['steps_per_s']:.2f} steps/s, {r['train_wall_s']:.2f} s, "
        f"peak device memory {r['peak_memory_gib']:.2f} GiB; re-scored (score_torch_semantic.py --weights, card): "
        f"2D IoU high touch {sc['iou_2d_high_touch']}, low touch {sc['iou_2d_low_touch']}, voxel IoU "
        f"{sc['voxel_iou_high_touch']} over {sc['mutual_surface_voxels']} voxels (gates > {TRAIN_IOU_BOUND}; "
        f"SEMANTIC_r05.json {SEMANTIC_R05['iou_2d_high_touch']} / {SEMANTIC_R05['iou_2d_low_touch']} / "
        f"{SEMANTIC_R05['voxel_iou_high_touch']}); one float32 step card vs CPU (TF32 off): loss "
        f"{losses[str(dev)]:.7f} / {losses['cpu']:.7f}, gradient max |diff| / the tensor's max |g|: worst "
        f"{worst} {rel[worst]:.3g} (bound {TRAIN_GRAD_TOL}), per tensor {json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})}; "
        f"control with cuDNN's TF32 on: worst {worst_tf32} {rel_tf32[worst_tf32]:.3g} (must exceed the bound), "
        f"per tensor {json.dumps({k: float(f'{v:.3g}') for k, v in rel_tf32.items()})}; {card}"
    )
    if not (abs(first - 0.6504) <= TRAIN_FIRST_TOL and last < TRAIN_LAST_BOUND):
        raise AssertionError(f"training loss {first} -> {last}")
    if not (sc["iou_2d_high_touch"] > TRAIN_IOU_BOUND and sc["voxel_iou_high_touch"] > TRAIN_IOU_BOUND):
        raise AssertionError(f"card-trained weights score {sc}")
    if not rel[worst] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"training gradients card vs CPU: {worst} {rel[worst]}")
    if not rel_tf32[worst_tf32] > TRAIN_GRAD_TOL:
        raise AssertionError(f"the TF32 control is within the bound ({rel_tf32[worst_tf32]}): the gate cannot see TF32")


def _stereo_rig():
    """(spec, baseline, half extents) of the live and dense-stereo phases:
    phase 9's room at the ZED's VGA eye size, the principal point at the
    centre (a zero-distortion calibration rectifies to itself)."""
    from ra_slam_tpu_torch.io.synthetic import SyntheticCameraSpec

    w, h = ZED_VGA
    spec = SyntheticCameraSpec(fx=ZED_FX, fy=ZED_FX, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
    return spec, 0.12, np.array([2.0, 1.5, 2.0])


def _render_pair(spec, baseline, he, eye, checker=0.5):
    """(left, right, left depth, world_T_left) of a rectified pair: the
    right camera is the left moved by the baseline along its x."""
    from ra_slam_tpu_torch.io.synthetic import look_at, render_box_room

    w_T_l = look_at(np.asarray(eye, np.float64), np.array([0.0, 0.0, 1.5]))
    w_T_r = w_T_l.copy()
    w_T_r[:3, 3] += w_T_l[:3, 0] * baseline
    left, depth, _, _ = render_box_room(spec, w_T_l, he, checker=checker)
    right = render_box_room(spec, w_T_r, he, checker=checker)[0]
    return left, right, depth, w_T_l


def phase_dense_stereo(dev, card):
    """12: dense stereo at the ZED's VGA eye size, D = 64, on a synthetic
    pair (phase 9's room with the 0.125 m texture of
    tests/test_stereo.py:158), card vs CPU and against the analytic depth."""
    from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
    from ra_slam_tpu_torch.features.stereo import dense_stereo_depth

    spec, baseline, he = _stereo_rig()
    left, right, depth_gt, _ = _render_pair(spec, baseline, he, (0.3, 0.0, 0.0), checker=0.125)
    fxb = spec.fx * baseline
    out = {}
    for d in ("cpu", dev):
        gl, gr = (rgb_to_gray(torch.as_tensor(a, device=d)) for a in (left, right))
        out[str(d)] = gl, gr, *(t.cpu().numpy() for t in dense_stereo_depth(gl, gr, fxb, max_disparity=DENSE_D))
    _, _, cd, cv = out["cpu"]
    gl, gr, gd, gv = out[str(dev)]
    clean = slice(2 * DENSE_D + 8, None)  # no sentinel cost reaches these columns' decisions
    edge_diff = int((cv != gv)[:, : 2 * DENSE_D + 8].sum())
    both = cv & gv
    rel_dev = float((np.abs(cd[both] - gd[both]) / cd[both]).max()) if both.any() else 0.0
    cover = float(gv[:, DENSE_D:].mean())
    rel = np.abs(gd[gv] - depth_gt[gv]) / depth_gt[gv]
    call = lambda: dense_stereo_depth(gl, gr, fxb, max_disparity=DENSE_D)
    ms = _median_ms(call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    H, W = gl.shape
    print(
        f"dense stereo ({W}x{H}, D {DENSE_D}, census 5x5, 9x9 box, {H * W * DENSE_D / 1e6:.1f} M cost cells): "
        f"card vs CPU: valid equal in the columns >= {2 * DENSE_D + 8}: {np.array_equal(cv[:, clean], gv[:, clean])}, "
        f"{edge_diff} pixels differ left of them (bound {DENSE_EDGE_SHARE} of those columns), depth max relative "
        f"|diff| {rel_dev:.3g} where both valid (bound {DENSE_DEPTH_TOL}); coverage of the columns >= {DENSE_D} "
        f"{cover:.4f} (gate > 0.5), median relative error against the analytic depth {float(np.median(rel)):.5f} "
        f"(gate < 0.05), share within 10% {float((rel < 0.1).mean()):.4f}; per call (median of {REPEATS}, CUDA "
        f"events, after an L2 flush) {ms:.3f} ms, peak device memory of a call {peak_mb:.1f} MiB; {card}"
    )
    if not (np.array_equal(cv[:, clean], gv[:, clean]) and edge_diff <= DENSE_EDGE_SHARE * H * (2 * DENSE_D + 8)):
        raise AssertionError(f"dense stereo card vs CPU: valid differs ({edge_diff} edge pixels)")
    if not rel_dev <= DENSE_DEPTH_TOL:
        raise AssertionError(f"dense stereo card vs CPU: depth {rel_dev}")
    if not (cover > 0.5 and np.median(rel) < 0.05):
        raise AssertionError(f"dense stereo: coverage {cover}, median relative error {np.median(rel)}")


# tests/test_capture.py's ZED factory calibration (HD)
ZED_CONF = """
[LEFT_CAM_HD]
fx=700.1
fy=700.2
cx=640.3
cy=360.4
k1=-0.17
k2=0.026
k3=0.0
p1=0.0001
p2=-0.0002

[RIGHT_CAM_HD]
fx=701.0
fy=701.1
cx=639.0
cy=361.0
k1=-0.171
k2=0.027

[STEREO]
Baseline=119.887
RX_HD=0.0021
CV_HD=0.0058
RZ_HD=-0.0009
"""


def phase_rectify(dev, card):
    """13: a rectifier from the ZED-like calibration scaled to VGA; a
    672x376 uint8 pair remapped on the card and on the CPU, exactly."""
    from ra_slam_tpu_torch.core import rectify
    from ra_slam_tpu_torch.io.capture import parse_zed_conf

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "SN000.conf")
        with open(path, "w") as f:
            f.write(ZED_CONF)
        c = parse_zed_conf(path, "720p")
    sx, sy = ZED_VGA[0] / 1280, ZED_VGA[1] / 720
    mono = lambda m: rectify.CalibMono(m["fx"] * sx, m["fy"] * sy, m["cx"] * sx, m["cy"] * sy,
                                       [m["k1"], m["k2"], m["p1"], m["p2"], m["k3"]])
    calib = rectify.CalibStereo(mono(c["left"]), mono(c["right"]), c["rotation"], [-c["baseline"], 0.0, 0.0])
    t0 = time.perf_counter()
    rect = rectify.StereoRectifier(ZED_VGA, calib, device=dev)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    w, h = ZED_VGA
    pair = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)]
    cpu = rect.rectify(*(torch.as_tensor(a) for a in pair))
    card_in = [torch.as_tensor(a, device=dev) for a in pair]
    gpu = rect.rectify(*card_in)
    same = all(torch.equal(a, b.cpu()) for a, b in zip(cpu, gpu))
    ms = _median_ms(lambda: rect.rectify(*card_in))
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        rect.rectify(*pair)  # numpy in and out, as ZedNativeCamera calls it
    host_ms = (time.perf_counter() - t0) / REPEATS * 1e3
    print(
        f"rectification (ZED-like calibration at {w}x{h}, k1 -0.17): fc {rect.cam_rect_matrix[0, 0]:.4f}, "
        f"fx*b {rect.focal_x_baseline:.4f}, maps built in {build_s:.3f} s; the pair remapped on the card == CPU: "
        f"{same}; per pair on the card (median of {REPEATS}, CUDA events, tensors on the card) {ms:.3f} ms, "
        f"numpy in and out through the card (host clock) {host_ms:.3f} ms; {card}"
    )
    if not same:
        raise AssertionError("rectification card vs CPU differs")


class _FakeZedStream:
    """`ZedNativeCamera`'s interface: rectified VGA pairs of the room
    along tests/test_live.py's path, rendered and put through the
    rectifier as ZedNativeCamera does."""

    def __init__(self, rectifier):
        self.rectifier, self.i, self.times, self.poses = rectifier, 0, [], {}

    def get_stereo_frame(self):
        spec, baseline, he = _stereo_rig()
        i = self.i
        left, right, _, w_T_l = _render_pair(spec, baseline, he, (0.3 - 0.01 * i, 0.005 * i, 0.01 * i))
        left, right = self.rectifier.rectify(left, right)
        self.poses[i] = np.linalg.inv(w_T_l.astype(np.float64))[:3]
        self.times.append(time.perf_counter())
        self.i += 1
        return left, right, i / 30.0

    def close(self):
        pass


class _FakeRgbdFromZed:
    """The RGB-D camera of the live phase in the `ZedDepthCamera` role:
    the left image and its dense stereo depth on the card. Waits for the
    first tracked pose, as tests/test_live.py's fake does, so that mapping
    overlaps tracking."""

    def __init__(self, system, rectifier, fxb, dev):
        from ra_slam_tpu_torch.io.cameras import ZedDepthCamera

        self.zed = ZedDepthCamera(rectifier, fxb, max_disparity=DENSE_D, device=dev, cam=_FakeZedStream(rectifier))
        self.system, self.times = system, []

    def get_rgbd_frame(self):
        if not self.times:
            t0 = time.monotonic()
            while len(self.system.slam.pose_buffer) == 0 and time.monotonic() - t0 < 120.0:
                time.sleep(0.05)
        _, (rgb, depth, ts) = self.zed.get_stereo_and_rgbd_frame()
        self.times.append(time.perf_counter())
        return rgb, depth, ts + 0.004  # a slightly offset clock, like a real rig


def phase_live(dev, card):
    """14: `live.run` on the card with fake cameras: the stereo thread
    tracks rectified VGA pairs, the mapping thread segments the left image
    with the default-width UNet (live.main's --model path) and fuses it
    with its dense stereo depth at the tracked poses."""
    from ra_slam_tpu_torch.core.config import FeatureConfig, SystemConfig, TrackingConfig, TsdfConfig
    from ra_slam_tpu_torch.core.rectify import CalibMono, CalibStereo, StereoRectifier, rewrite_camera_config
    from ra_slam_tpu_torch.eval.ate import ate_rmse
    from ra_slam_tpu_torch.io.png import read_png
    from ra_slam_tpu_torch.models.segmentation import InferenceEngine
    from ra_slam_tpu_torch.ops import hamming, tsdf_fuse
    from ra_slam_tpu_torch.pipeline import live
    from ra_slam_tpu_torch.pipeline.system import RaSlamSystem

    spec, baseline, he = _stereo_rig()
    mono = CalibMono(spec.fx, spec.fy, spec.cx, spec.cy, [0.0] * 5)
    rectifier = StereoRectifier(ZED_VGA, CalibStereo(mono, mono, [0.0, 0.0, 0.0], [-baseline, 0.0, 0.0]), device=dev)
    w, h = ZED_VGA
    cfg = rewrite_camera_config(SystemConfig(
        tsdf=TsdfConfig(voxel_size=0.02, truncation=0.12, max_depth=6.0, log2_num_blocks=15, log2_hash_size=17,
                        max_visible_blocks=1 << 14, max_new_blocks=1 << 15, width=w, height=h),
        feature=FeatureConfig(max_num_keypoints=1000, num_levels=3),
        tracking=TrackingConfig(min_inliers=10, match_radius=30.0).scaled(w / 240),
    ), rectifier)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, out = os.path.join(tmp, "seg.msgpack"), os.path.join(tmp, "previews")
        InferenceEngine("__random__", w, h, device=dev).save(ckpt)
        system = RaSlamSystem(cfg, dev, segmentation_model=ckpt)
        ranges, segment = [], system.seg.segment

        def segment_spy(rgb):  # the maps' (min, max), read after the run
            ht, lt = segment(rgb)
            ranges.append(torch.stack([ht.min(), ht.max(), lt.min(), lt.max()]))
            return ht, lt

        system.seg.segment = segment_spy
        stereo = _FakeZedStream(rectifier)
        rgbd = _FakeRgbdFromZed(system, rectifier, cfg.camera.focal_x_baseline, dev)
        torch.cuda.reset_peak_memory_stats()
        with _Timed(system, "feed_stereo_frame", False) as feed_s, _Timed(system, "feed_rgbd_frame", False) as feed_r, \
                _Timed(stereo, "get_stereo_frame", False) as get_s, _Timed(rgbd, "get_rgbd_frame", False) as get_r, \
                _Timed(system.seg, "segment", True) as segm:
            tsdf_fuse.LAUNCHES = hamming.LAUNCHES = 0
            t0 = time.perf_counter()
            n_prev, n_slam, n_tsdf = live.run(system, stereo, rgbd, out_dir=out, render_every_s=2.0,
                                              stop_after_frames=LIVE_FRAMES)
            wall = time.perf_counter() - t0
            fuse_launches, ham_launches = tsdf_fuse.LAUNCHES, hamming.LAUNCHES
        del system.seg.segment
        pngs = sorted(f for f in os.listdir(out) if f.startswith("live_"))
        shapes = [read_png(os.path.join(out, f)).shape for f in pngs]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    seg_ms = segm.ms()
    ranges = torch.stack(ranges).cpu().numpy() if ranges else np.zeros((0, 4), np.float32)
    probs = system.semantic_voxels()[:, 4]
    maps_ok = bool(len(ranges) and np.isfinite(ranges).all() and ranges[:, [0, 2]].min() >= 0.0
                   and ranges[:, [1, 3]].max() <= 1.0)
    probs_ok = bool(len(probs) and np.isfinite(probs).all() and probs.min() >= 0.0 and probs.max() <= 1.0)
    est = system.slam.trajectory()
    ate = ate_rmse(est, sorted(stereo.poses.items()))
    rate = lambda ts: (len(ts) - 1) / (ts[-1] - ts[0]) if len(ts) > 1 else 0.0
    alloc_failures = int(system.map.alloc_failures)
    print(
        f"live.run with fake cameras ({w}x{h} stereo pairs through the rectifier, RGB-D = left image + dense "
        f"stereo depth on the card): {n_slam} tracked, {n_tsdf} RGB-D frames, {system.num_integrated} fused, "
        f"{len(est)} poses, ATE {ate['ate_rmse']:.5f} m (gate <= {ATE_BOUND_M}), alloc_failures {alloc_failures}, "
        f"{n_prev} previews ({len(pngs)} files, {shapes[:1]}); tracking thread {rate(stereo.times):.2f} f/s, "
        f"mapping thread {rate(rgbd.times):.2f} f/s (from the cameras' calls), session {wall:.2f} s; per frame "
        f"(host clock, median): tracking thread camera {float(np.median(get_s.ms())):.1f} ms (render, rectify) + "
        f"feed_stereo_frame {float(np.median(feed_s.ms())):.1f} ms, mapping thread camera "
        f"{float(np.median(get_r.ms()[1:])):.1f} ms (render, rectify, dense stereo) + feed_rgbd_frame "
        f"{float(np.median(feed_r.ms())):.1f} ms (of which the UNet's segment, CUDA events, median "
        f"{float(np.median(seg_ms)) if seg_ms else float('nan'):.3f} ms, {len(seg_ms)} calls); high-touch maps in "
        f"[{ranges[:, 0].min() if len(ranges) else float('nan'):.4f}, "
        f"{ranges[:, 1].max() if len(ranges) else float('nan'):.4f}], {len(probs)} fused voxels' prob in "
        f"[{probs.min() if len(probs) else float('nan'):.4f}, {probs.max() if len(probs) else float('nan'):.4f}]; "
        f"{fuse_launches} fuse and {ham_launches} Hamming launches; peak device memory {peak_gb:.2f} GiB; {card}"
    )
    if not (n_slam >= LIVE_FRAMES and n_tsdf >= LIVE_FRAMES):
        raise AssertionError(f"live: {n_slam} / {n_tsdf} frames")
    if not ate["ate_rmse"] <= ATE_BOUND_M:
        raise AssertionError(f"live: ATE {ate}")
    if not (system.num_integrated >= LIVE_MIN_FUSED and alloc_failures == 0):
        raise AssertionError(f"live: {system.num_integrated} fused, {alloc_failures} allocation failures")
    if not (pngs and shapes[0] == (h, w, 4)):
        raise AssertionError(f"live: previews {pngs} {shapes}")
    if not (len(seg_ms) >= system.num_integrated and maps_ok and probs_ok):
        raise AssertionError(f"live: {len(seg_ms)} UNet calls for {system.num_integrated} fused frames, "
                             f"maps in [0, 1]: {maps_ok}, fused probabilities in [0, 1]: {probs_ok}")
    if not (ham_launches >= LIVE_FRAMES and fuse_launches >= system.num_integrated):
        raise AssertionError(f"live: {ham_launches} Hamming, {fuse_launches} fuse launches")
    return fuse_launches, ham_launches


def phase_native_io(sens_path, plain, plain_rows, card):
    """15: `offline_eval --sens --native-io` over phase 3e's file: the same
    map as 3e's run without the flag, byte for byte."""
    from ra_slam_tpu_torch.ops import tsdf_fuse
    from ra_slam_tpu_torch.pipeline import offline_eval

    with tempfile.TemporaryDirectory() as out:
        tsdf_fuse.LAUNCHES = 0
        r = offline_eval.main(["--sens", sens_path, "--native-io", "--max-frames", str(SENS_FRAMES), "--download", out])
        launches = tsdf_fuse.LAUNCHES
        rows = np.fromfile(os.path.join(out, "tsdf.bin"), "<f4").reshape(-1, 5)
    same = np.array_equal(rows, plain_rows) and all(r[k] == plain[k] for k in ("frames", "num_active", "tsdf_rows"))
    print(
        f".sens path with --native-io (two decode threads, eight frames ahead): {r['frames']} frames, {r['fps']} "
        f"fused frames/s end to end (3e without the flag: {plain['fps']}), {r['frames'] / r['integrate_s']:.2f} "
        f"inside feed_rgbd_frame; tsdf.bin equal to 3e's: {same}; {launches} fuse launches; {card}"
    )
    if not same:
        raise AssertionError(".sens --native-io differs from the plain read")
    if launches < SENS_FRAMES:
        raise AssertionError(f"--native-io: {launches} fuse launches")
    return launches


def phase_hamming_vs_plain(dev, card):
    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.eval.trajectory_bench import tracking_setup
    from ra_slam_tpu_torch.features.matching import unpack_pm1
    from ra_slam_tpu_torch.features.orb import detect_and_describe
    from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
    from ra_slam_tpu_torch.ops import hamming

    # the tracking shape: the next frame's descriptors against the map
    ds, slam = tracking_setup(640, 480, device=dev)
    for i in range(TRACK_WARM):
        fr = ds.frame(i)
        hint = SE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
        slam.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=hint)
    kp = detect_and_describe(rgb_to_gray(torch.as_tensor(ds.frame(TRACK_WARM).rgb).to(dev)), slam.fcfg)
    n_lm = int(slam.state.track.lms.valid.sum())

    rng = np.random.default_rng(0)
    words = lambda n: torch.as_tensor(
        rng.integers(-2**31, 2**31, (n, 8), dtype=np.int64).astype(np.int32), device=dev)
    cases = {
        "bench 1000x20000": (words(1000), words(20000)),
        "tracking": (kp.desc, slam.state.track.lms.desc),
        "ragged 130x300": (words(130), words(300)),
        "ragged 1001x129": (words(1001), words(129)),
        "kb % 4 != 0 17x20001": (words(17), words(20001)),
        "kb % 4 != 0 130x301": (words(130), words(301)),
        "empty 0x20000": (words(0), words(20000)),
        "empty 130x0": (words(130), words(0)),
    }
    out = {}
    for name, (a, b) in cases.items():
        k = hamming.hamming_matrix(a, b)
        p = hamming.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        if k.shape != (a.shape[0], b.shape[0]) or not torch.equal(k, p):
            raise AssertionError(f"hamming kernel vs plain differ at {name} {tuple(k.shape)}")
        print(f"hamming kernel == plain at {name}: [{a.shape[0]}, {b.shape[0]}], exact")
        if k.numel() < 10**7:
            continue
        lib, lib_route = _pm1_product(unpack_pm1(a), unpack_pm1(b))
        if not torch.equal((256.0 - lib()) / 2, k):
            raise AssertionError(f"the +-1 product ({lib_route}) differs from the kernel at {name}")
        kern = lambda: hamming.hamming_matrix(a, b)
        plain = lambda: hamming.hamming_matrix_plain(a, b)
        ms, plain_ms, lib_ms = _median_ms(kern), _median_ms(plain), _median_ms(lib)
        (_, kernel_dev, n_rec), (plain_dev, _, _) = _device_ms(kern, "hamming"), _device_ms(plain)
        nbytes = k.numel() * 4 + (a.shape[0] + b.shape[0]) * 32
        # the work as a +-1 int8 product (2 * 256 operations per output):
        # the data sheet gives no binary tensor-core rate
        bound_ms, bound_by = _bound(nbytes, k.numel() * 2 * 256, INT8_OPS_PER_S)
        print(
            f"hamming at {name} [{a.shape[0]}, {b.shape[0]}], each call after a {L2_FLUSH_BYTES >> 20} MiB "
            f"L2 flush: per call (median of {REPEATS}, CUDA events): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library ({lib_route}, then (256 - x) / 2 equal to the kernel) "
            f"{lib_ms:.4f} ms; device time (torch.profiler, mean): kernel {kernel_dev:.4f} ms ({n_rec} of "
            f"{REPEATS} launches recorded), plain "
            f"{plain_dev:.4f} ms; {nbytes / 1e6:.2f} MB = {nbytes / (kernel_dev / 1e3) / 1e9:.1f} GB/s; "
            f"bound {bound_ms:.4f} ms ({bound_by}), share of the bound: kernel {bound_ms / kernel_dev:.3f} "
            f"(device time), {bound_ms / ms:.3f} (per call), library {bound_ms / lib_ms:.3f} (per call); {card}"
        )
        out[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
    print(f"tracking shape after {TRACK_WARM} frames: {kp.desc.shape[0]} keypoint slots "
          f"({int(kp.valid.sum())} valid) x {slam.state.track.lms.desc.shape[0]} landmark slots "
          f"({n_lm} live)")
    return out["tracking"]


def _pm1_product(a_pm1, b_pm1):
    """The library yardstick of the Hamming kernel, never called by the
    port: one PyTorch call of the +-1 product that the JAX package takes
    off the TPU (`features/matching.py:hamming_matrix`), writing the same
    float32 [Ka, Kb] bytes. bf16 operands with a float32 product
    (`torch.mm(..., out_dtype=)`) where this torch has it, else float32
    operands with TF32 allowed for that call only. Returns (call, route)."""
    a16, b16 = a_pm1.to(torch.bfloat16), b_pm1.to(torch.bfloat16)
    try:
        torch.mm(a16[:1], b16[:1].T, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        def tf32():
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return torch.mm(a_pm1, b_pm1.T)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return tf32, "float32 mm, TF32"
    return (lambda: torch.mm(a16, b16.T, out_dtype=torch.float32)), "bf16 mm, float32 out"


def phase_tracking_path(card):
    from ra_slam_tpu_torch.eval import trajectory_bench
    from ra_slam_tpu_torch.ops import hamming

    torch.cuda.reset_peak_memory_stats()
    hamming.LAUNCHES = 0
    r = trajectory_bench.main([
        "--width", "640", "--height", "480", "--no-loop", "--frames", str(TRACK_FRAMES),
    ])
    launches = hamming.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"tracking path (loop closing off): {r['total_frames']} frames at 640x480, ATE {r['ate_rmse_m']} m, "
        f"RPE {r['rpe_trans_rmse_m']} m, lost {r['lost_frames']}, keyframes {r['keyframes']}, "
        f"relocalizations {r['relocalizations']}, {r['steady_state_fps']} tracked frames/s "
        f"(frames 1..{TRACK_FRAMES - 1}; {r['slam_fps']} with frame 0), "
        f"{r['host_syncs_per_frame']} host syncs/frame, {launches} Hamming launches, "
        f"peak device memory {peak_gb:.2f} GiB; {card}"
    )
    if r["lost_frames"] != 0 or r["matched_frames"] != TRACK_FRAMES:
        raise AssertionError(f"tracking lost frames: {r}")
    if not r["ate_rmse_m"] <= ATE_BOUND_M:
        raise AssertionError(f"ATE {r['ate_rmse_m']} m > {ATE_BOUND_M} m")
    if launches < TRACK_FRAMES:
        raise AssertionError(f"the tracking path launched the Hamming kernel {launches} times")
    return launches, r["ate_rmse_m"]


# the close branch's stages, by the names the frame step calls in
# `ra_slam_tpu_torch.slam.system`
CLOSE_STAGES = {"optimize_pose_graph": "PGO", "correct_landmarks": "landmark correction",
                "global_bundle_adjustment": "global BA"}


def phase_loop_tracking(card, ate_loop_off):
    from ra_slam_tpu_torch.eval import trajectory_bench
    from ra_slam_tpu_torch.ops import hamming
    from ra_slam_tpu_torch.slam import system as slam_system

    torch.cuda.reset_peak_memory_stats()
    hamming.LAUNCHES = 0
    with ExitStack() as stack:
        timers = {label: stack.enter_context(_Timed(slam_system, name, True))
                  for name, label in CLOSE_STAGES.items()}
        r, slam = trajectory_bench.main(
            ["--width", "640", "--height", "480", "--frames", str(TRACK_FRAMES)], return_system=True,
        )
    launches = hamming.LAUNCHES
    close_ms = "; ".join(f"{label} " + (", ".join(f"{t:.2f}" for t in timer.ms()) or "none") + " ms"
                         for label, timer in timers.items())
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"tracking path (loop closing on): {r['total_frames']} frames at 640x480, ATE {r['ate_rmse_m']} m "
        f"(loop off: {ate_loop_off} m), RPE {r['rpe_trans_rmse_m']} m, lost {r['lost_frames']}, "
        f"keyframes {r['keyframes']}, loop closures {r['loop_closures']}, relocalizations "
        f"{r['relocalizations']}, {r['steady_state_fps']} tracked frames/s (frames 1..{TRACK_FRAMES - 1}; "
        f"{r['slam_fps']} with frame 0), {r['host_syncs_per_frame']} host syncs/frame, {launches} Hamming "
        f"launches, peak device memory {peak_gb:.2f} GiB; {card}"
    )
    print(f"close branch per closure (CUDA events): {close_ms}; {card}")
    if r["lost_frames"] != 0 or r["matched_frames"] != TRACK_FRAMES:
        raise AssertionError(f"loop-on tracking lost frames: {r}")
    if r["loop_closures"] < 1 or r["relocalizations"] > 2:
        raise AssertionError(f"loop-on tracking: {r['loop_closures']} closures, {r['relocalizations']} relocalizations")
    if not (r["ate_rmse_m"] <= ATE_BOUND_M and r["ate_rmse_m"] < ate_loop_off):
        raise AssertionError(f"loop-on ATE {r['ate_rmse_m']} m: bound {ATE_BOUND_M} m, loop off {ate_loop_off} m")
    if launches < TRACK_FRAMES:
        raise AssertionError(f"the loop-on path launched the Hamming kernel {launches} times")
    return launches, slam


def phase_ba_pgo_device_vs_cpu(slam, card):
    from ra_slam_tpu_torch.slam.ba import gather_window, solve_window
    from ra_slam_tpu_torch.slam.pose_graph import optimize_pose_graph
    from ra_slam_tpu_torch.utils.convert import slam_state_from_numpy, slam_state_to_numpy

    p, cam = slam.params, slam.cam
    on_card = slam.state
    on_cpu = slam_state_from_numpy(slam_state_to_numpy(on_card), "cpu")
    kfc = int(on_card.track.kf_counter)
    start = max(kfc - p.gba_window, 0)

    def ba(s):
        win = gather_window(s.kfs, s.track.lms, kfc, p.gba_window, p.ba_max_points, start=start)
        poses, points, st = solve_window(win, cam, iterations=p.gba_iterations)
        return poses, torch.where(win.point_ok[:, None], points, 0.0), st

    def pgo(s):
        kfs, _ = optimize_pose_graph(s.kfs, s.edges, s.track.kf_counter, max_nodes=s.kfs.capacity,
                                     iterations=p.pgo_iterations)
        return kfs

    (Pg, Xg, sg), (Pc, Xc, sc) = ba(on_card), ba(on_cpu)
    Pg2, Xg2, _ = ba(on_card)
    kg, kc, kg2 = pgo(on_card), pgo(on_cpu), pgo(on_card)
    diff = lambda a, b: (a.cpu() - b.cpu()).abs().max().item()
    err = {
        "ba_pose_R": diff(Pg.R, Pc.R), "ba_pose_t": diff(Pg.t, Pc.t), "ba_points": diff(Xg, Xc),
        "pgo_R": diff(kg.R, kc.R), "pgo_t": diff(kg.t, kc.t),
    }
    same_ba = torch.equal(Pg.R, Pg2.R) and torch.equal(Pg.t, Pg2.t) and torch.equal(Xg, Xg2)
    same_pgo = torch.equal(kg.R, kg2.R) and torch.equal(kg.t, kg2.t)
    ba_ms = _median_ms(lambda: ba(on_card))
    pgo_ms = _median_ms(lambda: pgo(on_card))
    print(
        f"BA window (keyframes {start}..{start + p.gba_window - 1} of {kfc}, {int(sg.num_points)} points, "
        f"{int(sg.num_obs)} observations, rmse {float(sg.rmse_before):.4f} -> {float(sg.rmse_after):.4f} px on "
        f"the card, {float(sc.rmse_after):.4f} px on the CPU) and PGO ({p.pgo_iterations} iterations, "
        f"{int(on_card.n_edges)} edges, H {6 * on_card.kfs.capacity}^2): card vs CPU max |diff| "
        f"{json.dumps(err)} (bound {DEV_VS_CPU_TOL}); two card solves bit-equal: BA {same_ba}, PGO {same_pgo}; "
        f"per call (median of {REPEATS}, CUDA events): gather + solve_window {ba_ms:.3f} ms, "
        f"optimize_pose_graph {pgo_ms:.3f} ms; {card}"
    )
    for name, e in err.items():
        if not e <= DEV_VS_CPU_TOL:
            raise AssertionError(f"card vs CPU: {name} differs by {e} > {DEV_VS_CPU_TOL}")


def phase_full_system(card):
    from ra_slam_tpu_torch.ops import hamming, tsdf_fuse
    from ra_slam_tpu_torch.pipeline import offline_eval

    args = ["--synthetic", "--use-slam"]
    ds = offline_eval.load_dataset(offline_eval.build_parser().parse_args(args))
    world_T_cam0 = np.linalg.inv(np.asarray(ds.frame(0).cam_T_world, np.float64))
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        tsdf_fuse.LAUNCHES = hamming.LAUNCHES = 0
        r = offline_eval.main(args + ["--max-frames", str(FULL_FRAMES), "--download", tmp])
        fuse_launches, ham_launches = tsdf_fuse.LAUNCHES, hamming.LAUNCHES
        rows = np.fromfile(os.path.join(tmp, "tsdf.bin"), "<f4").reshape(-1, 5)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ate = r["ate"]["ate_rmse"]
    # the SLAM world is the first camera's frame: carry the map into the room's
    xyz = rows[:, :3].astype(np.float64) @ world_T_cam0[:3, :3].T + world_T_cam0[:3, 3]
    tsdf, prob = rows[:, 3], rows[:, 4]
    surf = np.abs(tsdf) < 0.2
    x, y, zz = np.abs(xyz[surf, 0]), np.abs(xyz[surf, 1]), np.abs(xyz[surf, 2])
    dist = np.abs(np.minimum(np.minimum(3.0 - x, 2.0 - y), 3.0 - zz))
    near_ht = xyz[surf, 0] > 2.95
    p_ht = prob[surf][near_ht].mean() if near_ht.any() else float("nan")
    print(
        f"full system: {FULL_FRAMES} VGA frames, {r['tracked_frames']} tracked, {r['frames']} fused, ATE "
        f"{ate} m, RPE {r['rpe']['rpe_trans_rmse']} m, loop closures {r['loop_closures']}, "
        f"{r['fps']} fused frames/s end to end (host rendering included), "
        f"{r['frames'] / r['integrate_s']:.2f} frames/s inside feed_rgbd_frame, track_s {r['track_s']} "
        f"({FULL_FRAMES / r['track_s']:.2f} tracked frames/s), alloc_failures {r['alloc_failures']}, "
        f"{r['tsdf_rows']} voxels dumped; surface voxels {int(surf.sum())}: distance to the walls median "
        f"{float(np.median(dist))} m, p99 {float(np.quantile(dist, 0.99))} m, +x wall p {p_ht}; "
        f"{fuse_launches} fuse and {ham_launches} Hamming launches; peak device memory {peak_gb:.2f} GiB; {card}"
    )
    if r["frames"] != r["tracked_frames"] or r["frames"] == 0 or r["alloc_failures"] != 0:
        raise AssertionError(f"full system: fused {r['frames']} of {r['tracked_frames']} tracked frames: {r}")
    if fuse_launches < r["frames"] or ham_launches < FULL_FRAMES:
        raise AssertionError(f"full system: {fuse_launches} fuse, {ham_launches} Hamming launches")
    if not ate <= ATE_BOUND_M:
        raise AssertionError(f"full system: ATE {ate} m > {ATE_BOUND_M} m")
    if not (np.median(dist) <= 0.02 and np.quantile(dist, 0.99) <= 0.08):
        raise AssertionError("full system: the fused surface is not on the room's walls")
    if not p_ht > 0.8:
        raise AssertionError(f"full system: high-touch wall p {p_ht}")
    return fuse_launches, ham_launches


def phase_stereo(dev, card):
    from ra_slam_tpu_torch.core.camera import PinholeCamera
    from ra_slam_tpu_torch.core.config import FeatureConfig, TrackingConfig
    from ra_slam_tpu_torch.core.se3 import SE3, log_se3
    from ra_slam_tpu_torch.io.synthetic import SyntheticCameraSpec
    from ra_slam_tpu_torch.ops import hamming
    from ra_slam_tpu_torch.slam.system import SlamSystem

    # tests/test_stereo.py's pair at 240x180, intrinsics scaled to VGA
    s = 640 / 240
    spec = SyntheticCameraSpec(fx=120.0 * s, fy=120.0 * s, cx=120.0 * s - 0.5, cy=90.0 * s - 0.5,
                               width=640, height=480)
    baseline, he = 0.12, np.array([2.0, 1.5, 2.0])
    cam = PinholeCamera.create(spec.fx, spec.fy, spec.cx, spec.cy, spec.width, spec.height)
    slam = SlamSystem(
        cam, fcfg=FeatureConfig(max_num_keypoints=1000, num_levels=3),
        tcfg=TrackingConfig(min_inliers=12, match_radius=30.0).scaled(s),
        ba_window=4, ba_max_points=1024, ba_iterations=3,
        focal_x_baseline=spec.fx * baseline, max_disparity=int(48 * s), device=dev,
    )
    hamming.LAUNCHES = 0
    errs, t0 = [], time.perf_counter()
    for i in range(STEREO_FRAMES):
        rgb_l, rgb_r, _, w_T_l = _render_pair(spec, baseline, he, (0.3 - 0.03 * i, 0.02 * i, 0.05 * i))
        gt = SE3.from_matrix(torch.as_tensor(np.linalg.inv(w_T_l), dtype=torch.float32, device=dev))
        info = slam.feed_stereo_frame(rgb_l, rgb_r, float(i), pose_hint=gt if i == 0 else None)
        if not info.tracked:
            raise AssertionError(f"stereo tracking lost at frame {i}")
        errs.append(torch.linalg.vector_norm(log_se3(info.pose @ gt.inverse())[3:]).item())
    launches = hamming.LAUNCHES
    print(
        f"stereo: {STEREO_FRAMES} rectified VGA pairs (fx*b {spec.fx * baseline:.1f} px m, max disparity "
        f"{int(48 * s)}), translation errors (m) {[round(e, 4) for e in errs]}, keyframes "
        f"{int(slam.state.track.kf_counter)}, {launches} Hamming launches, "
        f"{STEREO_FRAMES / (time.perf_counter() - t0):.2f} frames/s with host rendering; {card}"
    )
    if not max(errs) < 0.1:
        raise AssertionError(f"stereo translation errors {errs}")
    if launches < STEREO_FRAMES:
        raise AssertionError(f"stereo tracking launched the Hamming kernel {launches} times")
    return launches


def _all_fields_equal(a, b) -> bool:
    return torch.equal(a.table.key, b.table.key) and torch.equal(a.table.value, b.table.value) and all(
        torch.equal(getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a) if f.name != "table")


def _active_rows(maps):
    """(sorted keys, fields) of the active blocks of `maps` together."""
    keys = torch.cat([m.block_key[m.active] for m in maps])
    order = torch.argsort(keys)
    fields = {f: torch.cat([getattr(m, f)[m.active] for m in maps])[order]
              for f in ("tsdf", "weight", "rgb", "prob")}
    return keys[order], fields


def phase_sharded_fusion(dev, card):
    """16: the main path's fusion over 4 LocalMesh shards on the card."""
    from scipy.spatial import cKDTree
    import torch.distributed as dist

    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.map import voxel_map as vm
    from ra_slam_tpu_torch.map.blocks import INVALID_KEY, owner_of
    from ra_slam_tpu_torch.map.meshing import extract_mesh
    from ra_slam_tpu_torch.ops import tsdf_fuse
    from ra_slam_tpu_torch.parallel import (LocalMesh, ProcessGroupMesh, create_sharded_map, local_config,
                                            make_gather_shards, make_sharded_integrate_step)
    from ra_slam_tpu_torch.parallel.sharded_map import extract_mesh_sharded
    from ra_slam_tpu_torch.pipeline import offline_eval
    from ra_slam_tpu_torch.pipeline.bench_scaling import free_port

    args = offline_eval.build_parser().parse_args(["--synthetic"])
    ds = offline_eval.load_dataset(args)
    cfg = offline_eval.system_config(ds.camera, args).tsdf
    cam = ds.camera

    def frame(i):
        f = ds.frame(i)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return t(f.rgb), t(f.depth), t(f.ht), t(f.lt), cam, SE3.from_matrix(t(f.cam_T_world))

    frames = [frame(i) for i in range(SHARD_FRAMES)]

    def fuse(mesh, **kw):
        shards = create_sharded_map(cfg, mesh)
        step = make_sharded_integrate_step(mesh, cfg, alloc_stride=2, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fr in frames:
            shards, stats = step(shards, *fr)
        torch.cuda.synchronize()
        return shards, {k: int(v) for k, v in stats.items()}, len(frames) / (time.perf_counter() - t0)

    single = vm.create_map(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr in frames:
        _, st1 = vm.integrate_frame(single, *fr, cfg, alloc_stride=2)
    torch.cuda.synchronize()
    fps_single = len(frames) / (time.perf_counter() - t0)
    n_single = int(st1["num_active"])

    mesh = LocalMesh(SHARDS, dev)
    torch.cuda.reset_peak_memory_stats()
    tsdf_fuse.LAUNCHES = 0
    shards, st, fps = fuse(mesh)
    launches = tsdf_fuse.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    keys_s, rows_s = _active_rows(shards)
    keys_1, rows_1 = _active_rows([single])
    err = {f: (rows_s[f] - rows_1[f]).abs().max().item() for f in rows_s} if torch.equal(keys_s, keys_1) else None
    print(
        f"sharded fusion, {SHARDS} hash shards on one card ({local_config(cfg, SHARDS).num_blocks} blocks, "
        f"{local_config(cfg, SHARDS).max_visible_blocks} visible each), {SHARD_FRAMES} VGA frames: "
        f"{st['num_active']} active blocks (single map {n_single}), {st['num_visible']} visible at the last "
        f"frame, alloc_failures {st['alloc_failures']}; union vs the single map: keys equal "
        f"{err is not None}, max |diff| {json.dumps(err)} (bound {SHARD_TOL}); {fps:.2f} fused frames/s "
        f"(single map {fps_single:.2f}), {launches} fuse launches, peak device memory {peak_gb:.2f} GiB; {card}"
    )
    if st["num_active"] != n_single or st["alloc_failures"] != 0:
        raise AssertionError(f"sharded fusion: {st}, single map {n_single} active")
    if err is None or not max(err.values()) <= SHARD_TOL:
        raise AssertionError(f"the shards' union differs from the single map: {err}")
    if launches < SHARDS * SHARD_FRAMES:
        raise AssertionError(f"sharded fusion launched the fuse kernel {launches} times")

    # one shard, in process and over NCCL at world size 1: the same map
    one, st_one, fps_one = fuse(LocalMesh(1, dev))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        pg, st_pg, fps_pg = fuse(ProcessGroupMesh())
    finally:
        dist.destroy_process_group()
    same = _all_fields_equal(one[0], pg[0]) and st_one == st_pg
    print(f"one shard: LocalMesh(1) {fps_one:.2f} f/s, ProcessGroupMesh over NCCL (world size 1) {fps_pg:.2f} "
          f"f/s, the same map bit for bit: {same}; the same as the single map: "
          f"{_all_fields_equal(one[0], single)}; {card}")
    if not same:
        raise AssertionError("LocalMesh(1) and ProcessGroupMesh over NCCL fused different maps")
    del one, pg

    # the fuse kernel at one shard's shape: shard 0 takes frame 60
    lcfg = local_config(cfg, SHARDS)
    rgb, depth, ht, lt, _, pose = frame(SHARD_FRAMES)

    def allocate():
        keys = vm.depth_to_candidate_keys(depth, cam, pose, lcfg, 2)
        vm.allocate_keys(shards[0], torch.where(owner_of(keys, SHARDS) == 0, keys, INVALID_KEY))

    numbers = _fuse_kernel_numbers(shards[0], lcfg, cam, (rgb, depth, ht, lt, pose), allocate,
                                   f"shard 0 of {SHARDS} (frame {SHARD_FRAMES})", card)
    del shards, single

    # slab shards: the halo export against the gathered map's mesh
    tsdf_fuse.LAUNCHES = 0
    slab, st_s, fps_s = fuse(mesh, owner_mode="slab", cell_log2=1)
    launches += tsdf_fuse.LAUNCHES
    g, dropped = make_gather_shards(mesh, cfg)[0](slab)
    t0 = time.perf_counter()
    vg, tg, _ = extract_mesh(g, cfg)
    t_gathered = time.perf_counter() - t0
    del g
    tree_g = cKDTree(vg[tg].mean(axis=1))
    for mode in ("parallel", "sequential"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        v, t_, _, info = extract_mesh_sharded(slab, mesh, cfg, cell_log2=1, mode=mode)
        wall = time.perf_counter() - t0
        mesh_gb = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        c_s = v[t_].mean(axis=1)
        d_sg = tree_g.query(c_s, workers=-1)[0].max() if len(t_) else float("inf")
        d_gs = cKDTree(c_s).query(vg[tg].mean(axis=1), workers=-1)[0].max() if len(t_) else float("inf")
        print(
            f"slab shards ({SHARDS}, cell 2 blocks; {st_s['num_active']} active, {fps_s:.2f} fused f/s), "
            f"extract_mesh_sharded {mode}: {len(t_)} triangles (gathered map {len(tg)}), centroid distances "
            f"{d_sg:.2e} / {d_gs:.2e} m, stats {json.dumps(info)}, peak blocks per shard "
            f"{info['peak_blocks_per_shard']} = {info['peak_blocks_per_shard'] / st_s['num_active']:.3f} of the "
            f"map; {wall:.3f} s wall (gathered map's extract_mesh {t_gathered:.3f} s), peak device memory "
            f"above the shards {mesh_gb:.2f} GiB; {card}"
        )
        if len(t_) != len(tg) or info["dropped"] != 0 or int(dropped) != 0 or not (d_sg < 1e-3 and d_gs < 1e-3):
            raise AssertionError(f"sharded mesh {mode}: {len(t_)} vs {len(tg)} triangles, {info}, {d_sg}, {d_gs}")
    return launches, numbers


def _ba_problem(device):
    """tests/test_ba.py's problem (6 keyframes on a sideways track, 120
    points at 3-6 m, 200 px focal length at 320x240) perturbed as its
    `_perturb` does (poses 0.02, points 0.05), in the port's types."""
    from ra_slam_tpu_torch.core.camera import PinholeCamera
    from ra_slam_tpu_torch.core.se3 import SE3, exp_se3
    from ra_slam_tpu_torch.slam.keyframes import create_keyframes, insert_keyframe
    from ra_slam_tpu_torch.slam.landmarks import create_landmarks

    num_kf, num_pts, F = 6, 120, 160
    cam = PinholeCamera.create(200.0, 200.0, 159.5, 119.5, 320, 240)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-2.0, 2.0, num_pts), rng.uniform(-1.5, 1.5, num_pts),
                    rng.uniform(3.0, 6.0, num_pts)], axis=-1).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)
    kfs = create_keyframes(16, F, "cpu")
    lms = create_landmarks(1024, "cpu")
    lms = dataclasses.replace(lms, pos=lms.pos.index_copy(0, torch.arange(num_pts), t(pts)),
                              valid=lms.valid.index_fill(0, torch.arange(num_pts), True))
    obs_lm = t(np.r_[np.arange(num_pts), -np.ones(F - num_pts)], torch.int32)
    for k in range(num_kf):
        pose = exp_se3(t([0, 0.03 * k, 0, 0.15 * k, 0, 0]))
        uv, z = cam.project(pose.apply(t(pts)))
        w = (z > 0).float() * cam.in_bounds(uv).float()
        kfs = insert_keyframe(kfs, t(k, torch.int32), pose, t(k, torch.int32), t(k / 30.0),
                              obs_lm, torch.cat([uv, torch.zeros(F - num_pts, 2)]),
                              torch.cat([w, torch.zeros(F - num_pts)]), torch.zeros(F, 8, dtype=torch.int32))
    rng = np.random.default_rng(1)
    R, tr = kfs.R.clone(), kfs.t.clone()
    for k in range(1, num_kf):
        noisy = exp_se3(t(rng.normal(0, 0.02, 6))) @ SE3(kfs.R[k], kfs.t[k])
        R[k], tr[k] = noisy.R, noisy.t
    kfs = dataclasses.replace(kfs, R=R, t=tr)
    lms = dataclasses.replace(lms, pos=lms.pos.index_add(0, torch.arange(num_pts),
                                                         t(rng.normal(0, 0.05, (num_pts, 3)))))
    on = lambda x: dataclasses.replace(x, **{f.name: getattr(x, f.name).to(device) for f in dataclasses.fields(x)})
    return cam, on(kfs), on(lms), num_kf


def phase_dist_ba(dev, slam, card):
    """17: the distributed Schur solver on 4 LocalMesh shards on the
    card, then `refine_map` over a 2-shard mesh on phase 6's system."""
    from ra_slam_tpu_torch.parallel import LocalMesh, solve_window_distributed
    from ra_slam_tpu_torch.slam.ba import gather_window, solve_window

    out = {}
    for d in (dev, torch.device("cpu")):
        cam, kfs, lms, num_kf = _ba_problem(d)
        win = gather_window(kfs, lms, num_kf, 8, 256)
        mesh = LocalMesh(SHARDS, d, axis="ba")
        out[d.type] = (win, solve_window(win, cam, iterations=8),
                       solve_window_distributed(win, cam, mesh, iterations=8))
    win, (p1, x1, s1), (pd, xd, sd) = out["cuda"]
    _, (p1c, x1c, _), (pc, xc, sc) = out["cpu"]
    ok = win.point_ok
    diff = lambda a, b: (a.cpu() - b.cpu()).abs().max().item()
    err_single = {"poses_t": diff(pd.t, p1.t), "points": diff(xd[ok], x1[ok])}
    err_cpu = {"poses_R": diff(pd.R, pc.R), "poses_t": diff(pd.t, pc.t), "points": diff(xd[ok], xc[ok.cpu()])}
    err_single_cpu = {"poses_t": diff(p1.t, p1c.t), "points": diff(x1[ok], x1c[ok.cpu()])}
    mesh = LocalMesh(SHARDS, dev, axis="ba")
    single_ms = _median_ms(lambda: solve_window(win, cam, iterations=8))
    dist_ms = _median_ms(lambda: solve_window_distributed(win, cam, mesh, iterations=8))
    print(
        f"distributed BA ({SHARDS} shards, window 8, 256 points, {int(sd.num_obs)} observations): rmse "
        f"{float(sd.rmse_before):.4f} -> {float(sd.rmse_after):.6f} px (solve_window {float(s1.rmse_after):.6f}); "
        f"vs solve_window on the card max |diff| {json.dumps(err_single)} (bounds 1e-3 poses, 5e-3 points); "
        f"card vs CPU {json.dumps(err_cpu)} (bound {DEV_VS_CPU_TOL}; solve_window card vs CPU "
        f"{json.dumps(err_single_cpu)}); per call (median of {REPEATS}, CUDA "
        f"events): solve_window {single_ms:.3f} ms, solve_window_distributed {dist_ms:.3f} ms; {card}"
    )
    if not (err_single["poses_t"] <= 1e-3 and err_single["points"] <= 5e-3):
        raise AssertionError(f"distributed BA vs solve_window: {err_single}")
    if not max(err_cpu.values()) <= DEV_VS_CPU_TOL:
        raise AssertionError(f"distributed BA card vs CPU: {err_cpu}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = slam.refine_map(mesh=LocalMesh(2, dev, axis="ba"))
    print(f"refine_map over LocalMesh(2) on phase 6's map ({int(slam.state.track.kf_counter)} keyframes): "
          f"{json.dumps(r)}, {time.perf_counter() - t0:.2f} s; {card}")
    if not (np.isfinite(r["rmse_after"]) and r["rmse_after"] <= r["rmse_before"] + 0.5 and r["windows"] >= 1):
        raise AssertionError(f"refine_map over a mesh: {r}")


def phase_scaling(card):
    """18: bench_scaling on the card at 1, 2 and 4 shards."""
    from ra_slam_tpu_torch.ops import tsdf_fuse
    from ra_slam_tpu_torch.pipeline import bench_scaling

    tsdf_fuse.LAUNCHES = 0
    rows = [bench_scaling.run(["--devices", str(k), "--device", "cuda"] + SCALING_ARGS) for k in (1, 2, 4)]
    launches = tsdf_fuse.LAUNCHES
    print(f"bench_scaling at 1/2/4 shards: {[r['value'] for r in rows]} fused f/s, efficiencies "
          f"{[r.get('scaling_efficiency') for r in rows]}, {launches} fuse launches; {card}")
    if not all(r["value"] > 0 for r in rows) or launches < 24 * (1 + 2 + 4):
        raise AssertionError(f"bench_scaling: {rows}, {launches} launches")
    return launches


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))


def phase_jpeg(dev, card):
    """19: nvjpeg's encoder against cv2's at quality 95, and a JPEG
    `.sens` written on the card read back."""
    import cv2

    from ra_slam_tpu_torch.io import sens
    from ra_slam_tpu_torch.io.jpeg import decode_jpeg, encode_jpeg
    from ra_slam_tpu_torch.pipeline import offline_eval

    ds = offline_eval.load_dataset(offline_eval.build_parser().parse_args(["--synthetic"]))
    idx = list(range(0, 120, 120 // JPEG_FRAMES))[:JPEG_FRAMES]
    rgbs = [np.asarray(ds.frame(i).rgb).clip(0, 255).round().astype(np.uint8) for i in idx]
    depths = [np.round(np.asarray(ds.frame(i).depth) * 1000.0).astype(np.uint16) for i in idx]
    p_nv, p_cv, t_nv, t_cv, b_nv, b_cv = [], [], [], [], [], []
    for rgb in rgbs:
        t0 = time.perf_counter()
        nv = encode_jpeg(rgb, 95, dev)
        t_nv.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ok, enc = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, 95])
        t_cv.append(time.perf_counter() - t0)
        assert ok
        p_nv.append(_psnr(decode_jpeg(nv, dev).cpu().numpy(), rgb))
        p_cv.append(_psnr(decode_jpeg(enc.tobytes(), dev).cpu().numpy(), rgb))
        b_nv.append(len(nv))
        b_cv.append(len(enc))
    gap = max(abs(a - b) for a, b in zip(p_nv, p_cv))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jpeg.sens")
        k = np.array([[320.0, 0, 319.5], [0, 320.0, 239.5], [0, 0, 1]], np.float32)
        t0 = time.perf_counter()
        sens.write_sens(path, rgbs, depths, [np.eye(4, dtype=np.float32)] * len(rgbs), k,
                        color_compression=sens.COLOR_JPEG, device=dev)
        t_write = time.perf_counter() - t0
        r = sens.SensReader(path)
        depth_exact = all(np.array_equal(r._raw_depth(i), d) for i, d in enumerate(depths))
        p_sens = [_psnr(r.frame(i).rgb, rgb) for i, rgb in enumerate(rgbs)]
        r.close()
    print(
        f"JPEG at quality 95, {len(rgbs)} VGA orbit frames: PSNR nvjpeg {np.mean(p_nv):.3f} dB (min "
        f"{min(p_nv):.3f}), cv2 {np.mean(p_cv):.3f} dB (min {min(p_cv):.3f}), largest gap {gap:.3f} dB (bound "
        f"{JPEG_PSNR_DB}); bytes per frame nvjpeg {np.mean(b_nv):.0f}, cv2 {np.mean(b_cv):.0f}; encode per frame "
        f"(host clock, median) nvjpeg {1e3 * np.median(t_nv):.3f} ms (upload and download included), cv2 "
        f"{1e3 * np.median(t_cv):.3f} ms; write_sens(COLOR_JPEG) {t_write:.2f} s, read back: depth exact "
        f"{depth_exact}, colour PSNR min {min(p_sens):.3f} dB; {card}"
    )
    if not gap <= JPEG_PSNR_DB:
        raise AssertionError(f"nvjpeg's PSNR is {gap} dB from cv2's")
    if not depth_exact or not all(p >= c - JPEG_PSNR_DB for p, c in zip(p_sens, p_cv)):
        raise AssertionError(f"JPEG .sens round trip: depth exact {depth_exact}, PSNR {p_sens}")


def phase_eval_rows(card):
    """20: the EVAL matrix's seed-0 baseline pair on the card."""
    from ra_slam_tpu_torch.eval.trajectory_bench import run_trajectory_eval
    from ra_slam_tpu_torch.ops import hamming

    ev = _load_script("gen_eval_torch")
    hamming.LAUNCHES = 0
    rows = {}
    for loop in (True, False):
        rows[loop] = run_trajectory_eval(n_frames=ev.N_FRAMES, width=ev.W, height=ev.H, scene_kw=ev.HARD, seed=0,
                                         loop_closure=loop, device="cuda")
        r = rows[loop]
        print(f"EVAL seed 0, loop {'on' if loop else 'off'}: ATE {r['ate_rmse_m']} m (the JAX package "
              f"{json.dumps(EVAL_JAX_SEED0[loop])} op by op, {json.dumps(EVAL_JAX_JIT_SEED0[loop])} jitted; "
              f"EVAL_r05.json {EVAL_R05_ATE[loop]}, 0 lost), lost "
              f"{r['lost_frames']}, closures {r['loop_closures']}, relocalizations {r['relocalizations']}, "
              f"keyframes {r['keyframes']}, {r['steady_state_fps']} tracked f/s; {card}")
    launches = hamming.LAUNCHES
    on, off = rows[True], rows[False]
    if on["loop_closures"] < 1 or not on["ate_rmse_m"] < off["ate_rmse_m"]:
        raise AssertionError(f"EVAL seed 0: loop on {on}, loop off {off}")
    for loop, r in rows.items():
        want = EVAL_JAX_SEED0[loop]
        if (r["lost_frames"], r["loop_closures"]) != (want["lost_frames"], want["loop_closures"]) or not abs(
                r["ate_rmse_m"] - want["ate_rmse_m"]) <= EVAL_ATE_TOL:
            raise AssertionError(f"EVAL seed 0 loop {loop}: {r} vs the JAX package's {want}")
    if launches < 2 * ev.N_FRAMES:
        raise AssertionError(f"the EVAL rows launched the Hamming kernel {launches} times")
    return launches


def _eval_row(ev, name):
    """(seed, loop closing, other keywords) of a named row of the EVAL
    matrix (the seed-0 baseline with loop closing is `baseline`)."""
    found = {}

    def run(tag, **kw):
        if tag != "baseline" or kw.get("loop_closure", True):
            found.setdefault(tag, kw)

    ev.matrix(run, seeds=(0,), ablation_seeds=(0,))
    kw = dict(found[name])
    return kw.pop("seed", 0), kw.pop("loop_closure", True), kw


def _lockstep_fixture(path):
    """(frame, row, JAX state before it as nested namespaces, the JAX
    op-by-op step's FrameInfo, the jitted step's) of one
    tests/data/lockstep_*.npz (tests/data/make_lockstep_fixtures.py)."""
    from types import SimpleNamespace

    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    root: dict = {}
    for key, v in d.items():
        if key.startswith("before."):
            node = root
            parts = key[len("before."):].split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    ns = lambda x: SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v for k, v in x.items()})
    side = lambda p: {k[len(p) + 1:]: v for k, v in d.items() if k.startswith(p + ".")}
    return int(d["meta.frame"]), str(d["meta.row"]), ns(root), side("info"), side("jit")


def phase_carried_steps(card):
    """20b: tests/test_torch_lockstep.py's carried steps on the card."""
    import glob

    from ra_slam_tpu_torch.eval.trajectory_bench import tracking_setup
    from ra_slam_tpu_torch.features.orb import detect_and_describe
    from ra_slam_tpu_torch.features.pyramid import rgb_to_gray
    from ra_slam_tpu_torch.ops import hamming
    from ra_slam_tpu_torch.utils.convert import slam_state_from_numpy

    ev = _load_script("gen_eval_torch")
    here = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(here, "tests", "data", "lockstep_*.npz")))
    # the frames' ORB on the card equals the CPU's bit for bit (the
    # pyramid's chained sums and the FAST ring sums are device-independent)
    for path in paths:
        frame, row, *_ = _lockstep_fixture(path)
        seed, loop, kw = _eval_row(ev, row)
        ds, slam = tracking_setup(ev.W, ev.H, 0.005, seed, ev.HARD, "cpu", loop, **kw)
        gray = rgb_to_gray(torch.as_tensor(ds.frame(frame).rgb))
        kc, kg = detect_and_describe(gray, slam.fcfg), detect_and_describe(gray.cuda(), slam.fcfg)
        same = {f: bool(torch.equal(getattr(kc, f), getattr(kg, f).cpu())) for f in ("uv", "valid", "score", "desc")}
        print(f"ORB of {row} frame {frame}, card against CPU: {same}; angles "
              f"{float((kc.angle - kg.angle.cpu()).abs().max()):.2e} rad apart")
        if not all(same.values()):
            raise AssertionError(f"ORB of frame {frame} differs between the card and the CPU: {same}")
    if len(paths) < 3:
        raise AssertionError(f"carried-step fixtures: {paths}")
    hamming.LAUNCHES = 0
    for path in paths:
        frame, row, before, info, jit = _lockstep_fixture(path)
        seed, loop, kw = _eval_row(ev, row)
        ds, slam = tracking_setup(ev.W, ev.H, 0.005, seed, ev.HARD, "cuda", loop, **kw)
        slam.state = slam_state_from_numpy(before, "cuda")
        fr = ds.frame(frame)
        t0 = time.perf_counter()
        out = slam.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=frame)
        got = {k: getattr(out, k) for k in LOCKSTEP_DISCRETE}
        ms = (time.perf_counter() - t0) * 1e3
        gap_t = float(np.abs(out.pose.t.cpu().numpy() - info["t"]).max())
        gap_r = float(np.abs(out.pose.R.cpu().numpy() - info["R"]).max())
        parted = [k for k in LOCKSTEP_DISCRETE if got[k] != int(info[k])]
        print(f"carried step {row} frame {frame} on the card: {got['num_matches']} matches / "
              f"{got['num_inliers']} inliers, tracked {got['tracked']}, relocalized {got['relocalized']}, "
              f"keyframe {got['inserted_keyframe']}, BA rmse {out.ba_rmse:.6f} px (the JAX step op by op: "
              f"{int(info['num_matches'])} / {int(info['num_inliers'])}, BA rmse {float(info['ba_rmse']):.6f}; "
              f"jitted: {int(jit['num_matches'])} / {int(jit['num_inliers'])}); pose {gap_t:.2e} m / {gap_r:.2e} "
              f"from op by op (bound {LOCKSTEP_POSE_TOL}); {ms:.0f} ms; {card}")
        if parted or not max(gap_t, gap_r) <= LOCKSTEP_POSE_TOL:
            raise AssertionError(f"carried step {row} frame {frame}: {parted} differ from the JAX op-by-op step "
                                 f"({got} vs {info}), pose {gap_t} / {gap_r}")
    launches = hamming.LAUNCHES
    if launches < len(paths):
        raise AssertionError(f"the carried steps launched the Hamming kernel {launches} times")
    return launches


def phase_ba1_row(card):
    """20c: the EVAL matrix's `ba1` row free-running on the card, beside
    the port on the CPU and the jitted JAX package (reported, not
    gated: a free run on this path follows the last bit)."""
    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.eval.ate import ate_rmse
    from ra_slam_tpu_torch.eval.trajectory_bench import tracking_setup
    from ra_slam_tpu_torch.ops import hamming

    ev = _load_script("gen_eval_torch")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "data", "lockstep_traces.json")) as f:
        traces = json.load(f)
    keys, cpu = traces["keys"], traces["rows"]["ba1"]
    seed, loop, kw = _eval_row(ev, "ba1")
    ds, slam = tracking_setup(ev.W, ev.H, 0.005, seed, ev.HARD, "cuda", loop, **kw)
    hamming.LAUNCHES = 0
    trace, gt = [], []
    t0 = time.perf_counter()
    for i in range(ev.N_FRAMES):
        fr = ds.frame(i)
        hint = SE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
        info = slam.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=hint)
        trace.append([int(getattr(info, k)) for k in keys])
        gt.append((i, np.asarray(fr.cam_T_world)[:3, :4]))
    torch.cuda.synchronize()
    fps = ev.N_FRAMES / (time.perf_counter() - t0)
    launches = hamming.LAUNCHES
    ate = float(ate_rmse(slam.trajectory(), gt)["ate_rmse"])
    card_row = {"ate_rmse_m": round(ate, 4), "lost_frames": sum(1 - t[keys.index("tracked")] for t in trace),
                "relocalizations": slam.num_relocalizations, "keyframes": int(slam.state.track.kf_counter),
                "loop_closures": slam.num_loop_closures, "tracked_fps": round(fps, 2)}
    sides = {"port_cpu": "the port on the CPU", "jax_op_by_op_cpu": "the JAX package op by op on the CPU",
             "jax_jit_cpu": "the JAX package jitted on the CPU"}
    first = {side: next((i for i, (a, b) in enumerate(zip(trace, cpu[side])) if a != b), None)
             for side in sides if side in cpu}
    print(f"EVAL ba1 row, free-running: the card {json.dumps(card_row)}; "
          + "; ".join(f"{sides[s]} {json.dumps(cpu['summary'][s])}" for s in first)
          + f" (scripts/lockstep_torch_jax.py); the card's discrete trace ({', '.join(keys)}) first parts "
          + ", ".join(f"from {sides[s]} at frame {first[s]}" for s in first)
          + f"; {launches} Hamming launches; {card}")
    if first["port_cpu"] is not None and first["port_cpu"] < 17:
        print(f"the card parts from the port on the CPU before frame 17: at frame {first['port_cpu']}, "
              f"card {trace[first['port_cpu']]} vs CPU {cpu['port_cpu'][first['port_cpu']]}")
    if not np.isfinite(ate) or launches < ev.N_FRAMES:
        raise AssertionError(f"EVAL ba1 row: ATE {ate}, {launches} Hamming launches")
    return launches


def phase_pyramid_shapes(card):
    """20d: at every input shape the port builds a pyramid for (640x480
    and 672x376 at 8 levels, 320x240 at 4), a frame of the EVAL scene:
    every level, its blur and the ORB keypoints (uv, valid, score,
    descriptors; VGA at the facade's default `FeatureConfig`, 672x376 at
    the live cell's 1000 keypoints on 3 levels) on the card equal the
    CPU's bit for bit."""
    from ra_slam_tpu_torch.core.config import FeatureConfig
    from ra_slam_tpu_torch.features.orb import detect_and_describe
    from ra_slam_tpu_torch.features.pyramid import build_pyramid, gaussian_blur, rgb_to_gray
    from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    for (w, h), levels, feature_kw in PYRAMID_SHAPES:
        fcfg, f = FeatureConfig(**feature_kw), w / 2.0
        spec = SyntheticCameraSpec(fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0, width=w, height=h)
        rgb = SyntheticBoxDataset(num_frames=120, cam=spec, radius=1.0, depth_noise=0.005, clutter=6).frame(1).rgb
        gray = rgb_to_gray(torch.as_tensor(rgb))
        lc, lg = build_pyramid(gray, levels), build_pyramid(gray.cuda(), levels)
        parted = [i for i, (a, b) in enumerate(zip(lc, lg)) if not torch.equal(a, b.cpu())]
        parted += [f"blur {i}" for i, (a, b) in enumerate(zip(lc, lg)) if not torch.equal(
            gaussian_blur(a), gaussian_blur(b).cpu())]
        kc, kg = detect_and_describe(gray, fcfg), detect_and_describe(gray.cuda(), fcfg)
        parted += [k for k in ("uv", "valid", "score", "desc") if not torch.equal(getattr(kc, k), getattr(kg, k).cpu())]
        print(f"{w}x{h} at {levels} levels: every level and its blur, and the ORB keypoints ({fcfg.num_levels} "
              f"levels, {int(kc.valid.sum())} valid of {kc.capacity}), card against CPU: "
              f"{'bit-equal' if not parted else f'{parted} differ'}; {card}")
        if parted:
            raise AssertionError(f"{w}x{h}: {parted} differ between the card and the CPU")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    from ra_slam_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 rigid transforms
    card = _smi()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, together
        for job in [pool.submit(_build.load_library, name) for name in KERNELS]:
            job.result()  # re-raises a failed build
    for name in KERNELS:
        build_s = _build.BUILD_SECONDS.get(name)
        built = f"nvcc {build_s:.2f} s" if build_s is not None else "library of these sources already built"
        print(f"{name} build: {built}")
        print((_build.library_dir(name) / "build.log").read_text().strip())
    print(f"builds done in {time.perf_counter() - t0:.2f} s (in parallel)")
    decoders = probe_decoders()

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {label} wall time {time.perf_counter() - t0:.2f} s")
        return out

    numbers = phase("2", phase_kernel_vs_plain, dev, card)
    phase("2b", phase_fusion_device_vs_cpu, dev, card)
    launches, system = phase("3", phase_main_path, card)
    phase("3b", phase_raycast, system, card)
    del system
    phase("3c", phase_readers_device_vs_cpu, dev, card)
    launches += phase("3d", phase_recorded_folder, dev, card)
    sens_launches, native_launches = phase("3e and 15", phase_recorded_sens, dev, card, decoders)
    launches += sens_launches + native_launches
    phase("3f", phase_unet_resize_device_vs_cpu, dev, card)
    phase("3g", phase_seg_latency, dev, card)
    phase("3h", phase_rescore, card)
    phase("11", phase_training, dev, card)
    ham_numbers = phase("4", phase_hamming_vs_plain, dev, card)
    ham_launches, ate_loop_off = phase("5", phase_tracking_path, card)
    loop_launches, slam = phase("6", phase_loop_tracking, card, ate_loop_off)
    phase("7", phase_ba_pgo_device_vs_cpu, slam, card)
    phase("17", phase_dist_ba, dev, slam, card)
    del slam
    full_fuse, full_ham = phase("8", phase_full_system, card)
    stereo_launches = phase("9", phase_stereo, dev, card)
    phase("12", phase_dense_stereo, dev, card)
    phase("13", phase_rectify, dev, card)
    live_fuse, live_ham = phase("14", phase_live, dev, card)
    shard_fuse, shard_numbers = phase("16", phase_sharded_fusion, dev, card)
    scaling_fuse = phase("18", phase_scaling, card)
    phase("19", phase_jpeg, dev, card)
    eval_ham = phase("20", phase_eval_rows, card)
    carried_ham = phase("20b", phase_carried_steps, card)
    ba1_ham = phase("20c", phase_ba1_row, card)
    phase("20d", phase_pyramid_shapes, card)
    launches += full_fuse + live_fuse + shard_fuse + scaling_fuse
    ham_launches += loop_launches + full_ham + stereo_launches + live_ham + eval_ham + carried_ham + ba1_ham
    print(f"the fuse kernel at one shard's shape (phase 16): {json.dumps(shard_numbers)}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "tsdf_fuse",
        "route": "cuda",
        "source": "ra_slam_tpu_torch/csrc/tsdf_fuse.cu",
        "replaces": "ra_slam_tpu/ops/tsdf_pallas.py:156",
        "launches": launches,
        **numbers,
    }, {
        "name": "hamming",
        "route": "cuda",
        "source": "ra_slam_tpu_torch/csrc/hamming.cu",
        "replaces": "ra_slam_tpu/ops/hamming.py:52",
        "launches": ham_launches,
        **ham_numbers,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
