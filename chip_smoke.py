#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ra_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository. Four phases, none of whose failures
is caught:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of the CUDA fuse kernel from csrc/ with nvcc;
  2. the kernel against its plain PyTorch version at the main path's
     shapes: after 10 fused frames of the VGA synthetic orbit at the
     offline_eval defaults (1 cm voxels, 2^17 blocks, 2^19 hash slots,
     16384 visible blocks), one more frame through each, from the same
     state; fields within the stated bounds, the same carve releases,
     median times over 20 repeats with CUDA events;
  3. the main path: `ra_slam_tpu_torch.pipeline.offline_eval` over 60
     frames on cuda, with the kernel's launch count read around it, and
     the dumped map checked against the room's known geometry;
  4. a JSON line of the kernels' numbers, then the result line.

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

import numpy as np
import torch

FRAMES_BEFORE = 10  # fused frames before the kernel/plain comparison
MAIN_FRAMES = 60
REPEATS = 20
# kernel vs plain: the same float32 operations in the same order (no FMA
# contraction, IEEE division); only the device's log/exp/log1p and the
# summation inside the rigid transform may differ by an ulp
TOL = {"tsdf": 2e-5, "weight": 2e-5, "prob": 2e-5, "minabs": 2e-5, "rgb": 1e-3}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def _median_ms(fn) -> float:
    fn()  # warm-up
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_ms(fn, only=""):
    """Mean device time per call, over REPEATS calls (torch.profiler), of
    everything `fn` runs on the card (kernels and copies) and of the
    kernels whose name holds `only`: unlike the CUDA-event time it leaves
    out the gaps where the card waits on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in dev)
    named = sum(e.time_range.elapsed_us() for e in dev if only in e.name)
    return total / 1e3 / REPEATS, named / 1e3 / REPEATS


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
    from ra_slam_tpu_torch.ops import tsdf_fuse
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
    H, W = depth.shape
    _, t_alloc = _event_ms(lambda: vm.allocate_from_depth(m, depth, cam, pose, cfg, stride))
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
    (dev_ms, kernel_ms), (plain_dev_ms, _) = _device_ms(kernel, "tsdf_fuse"), _device_ms(plain)
    del mk, mp
    _, t_carve = _event_ms(lambda: vm.integrate(m, *fuse_args[:2], rgb, depth, ht, lt, cam, pose, cfg, carve=True))
    # the least device-memory traffic of the kernel: per voxel the pool
    # state (6 x 4 B) and the prep (pix, z, d2r, gate: 4 x 4 B) read once,
    # the image read once, the pool state of updated voxels written once
    min_bytes = n_vis * 512 * 40 + img6.numel() * 4 + updated * 24
    print(
        f"tsdf_fuse at frame {FRAMES_BEFORE}: {n_vis} visible blocks ({n_vis * 512} voxels, "
        f"{int(rel_k.sum())} released, {updated} voxels updated), "
        f"per call (median of {REPEATS}, CUDA events, index validation included): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; device time per call "
        f"(torch.profiler, mean): kernel call {dev_ms:.4f} ms of which the kernel "
        f"{kernel_ms:.4f} ms, plain {plain_dev_ms:.4f} ms; kernel moves >= "
        f"{min_bytes / 1e6:.1f} MB = {min_bytes / (kernel_ms / 1e3) / 1e9:.1f} GB/s, "
        f"roofline share {min_bytes / HBM_BYTES_PER_S / (kernel_ms / 1e3):.3f} of 3.35 TB/s; {card}"
    )
    print(
        f"one frame by stage (ms, single run): allocate {t_alloc:.3f}, cull {t_cull:.3f}, "
        f"prep {t_prep:.3f}, integrate (prep+fuse+carve) {t_carve:.3f}; {card}"
    )
    return {"max_abs_err": max(err.values()), "ms": ms, "plain_ms": plain_ms}


def phase_main_path(card):
    from ra_slam_tpu_torch.ops import tsdf_fuse
    from ra_slam_tpu_torch.pipeline import offline_eval

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        tsdf_fuse.LAUNCHES = 0
        r = offline_eval.main(
            ["--synthetic", "--max-frames", str(MAIN_FRAMES), "--download", tmp]
        )
        launches = tsdf_fuse.LAUNCHES
        rows = np.fromfile(os.path.join(tmp, "tsdf.bin"), "<f4").reshape(-1, 5)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    if r["frames"] != MAIN_FRAMES:
        raise AssertionError(f"fused {r['frames']} of {MAIN_FRAMES} frames")
    if r["alloc_failures"] != 0 or r["num_active"] <= 0:
        raise AssertionError(f"allocation: {r}")
    if launches < MAIN_FRAMES:
        raise AssertionError(f"the main path launched the kernel {launches} times")
    if r["tsdf_rows"] <= 0 or len(rows) != r["tsdf_rows"]:
        raise AssertionError(f"tsdf.bin holds {len(rows)} rows, the run reported {r['tsdf_rows']}")
    tsdf, prob = rows[:, 3], rows[:, 4]
    if not (np.isfinite(rows).all() and (np.abs(tsdf) <= 1).all() and ((prob >= 0) & (prob <= 1)).all()):
        raise AssertionError("tsdf.bin holds values outside tsdf [-1, 1] / prob [0, 1]")

    # the room is the box |x| <= 3, |y| <= 2, |z| <= 3 m, and its +x wall
    # is the high-touch class (p = 0.95, the other walls 0.05)
    surf = rows[np.abs(tsdf) < 0.2]
    x, y, zz = np.abs(surf[:, 0]), np.abs(surf[:, 1]), np.abs(surf[:, 2])
    dist = np.abs(np.minimum(np.minimum(3.0 - x, 2.0 - y), 3.0 - zz))
    near_ht = surf[:, 0] > 2.95
    p_ht, p_lt = surf[near_ht, 4].mean(), surf[surf[:, 0] < 2.9, 4].mean()
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
        f"(incl. host rendering of the synthetic frames), "
        f"{r['frames'] / r['integrate_s']:.2f} frames/s inside feed_rgbd_frame; "
        f"{r['num_active']} active blocks, {r['tsdf_rows']} voxels dumped, "
        f"{launches} kernel launches, peak device memory {peak_gb:.2f} GiB; {card}"
    )
    return launches


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
    _build.load_library("tsdf_fuse")
    build_s = _build.BUILD_SECONDS.get("tsdf_fuse")
    built = f"nvcc {build_s:.2f} s" if build_s is not None else "library of these sources already built"
    print(f"tsdf_fuse build: {built} (load {time.perf_counter() - t0:.2f} s)")
    print((_build.library_dir("tsdf_fuse") / "build.log").read_text().strip())

    numbers = phase_kernel_vs_plain(dev, card)
    launches = phase_main_path(card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "tsdf_fuse",
        "route": "cuda",
        "source": "ra_slam_tpu_torch/csrc/tsdf_fuse.cu",
        "replaces": "ra_slam_tpu/ops/tsdf_pallas.py:156",
        "launches": launches,
        **numbers,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
