"""Cold-L2 device times of the PyTorch port's two CUDA kernels on one
NVIDIA GPU, each against its bound.

    python3 scripts/bench_torch_kernels.py

Builds `ra_slam_tpu_torch/csrc/tsdf_fuse.cu` and `csrc/hamming.cu` with
nvcc (one each, started together) and prints nvcc's register and
shared-memory report. Then times, each call after a 256 MiB write that
flushes the 50 MB L2 (as the main path finds it after a frame's other
work):

- the fuse kernel and its plain version at the main path's shape (frame
  10 of `offline_eval --synthetic`'s VGA orbit, fused at its defaults,
  after frames 0-9) and at one shard's (shard 0 of 4 LocalMesh hash
  shards, frame 60 after 60 sharded frames);
- the Hamming kernel at 1000 x 20000 and 600 x 20000 (random words), the
  library yardstick (one `torch.mm` of the +-1 forms, checked equal to
  the kernel after (256 - x) / 2) and a `fill_` of the same output bytes
  (what plain writes reach on this card). At 600 x 20000 the 48 MB
  output fits in the 50 MB L2, whose write-back can end the kernel before
  its bytes reach device memory: there a share above 1 is the L2's.

Each time is a median of 20 calls by CUDA events and a mean device time
by kernel name from torch.profiler (it may drop records; their count is
printed). The bound is the least time for the same work: the larger of
the bytes over 3.35 TB/s and the operations over their type's peak. The
fuse kernel's byte count here is the bytes the kernel reads and writes,
prep arrays included; beside it is `benchmark/harness/work.py:fuse_bytes`,
the fusion's least traffic, which the benchmark's `fuse_roofline` reads.
Correctness is the `cuda` tests' (tests/test_torch_cuda.py). Every line
ends with the card's nvidia-smi name and power limit; the last is the
`kernels` JSON line.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark.harness.work import fuse_bytes  # noqa: E402
from ra_slam_tpu_torch.ops import _build, hamming, tsdf_fuse  # noqa: E402

KERNELS = ("tsdf_fuse", "hamming")
REPEATS = 20
FRAMES_BEFORE = 10  # fused frames before the main path's timed frame
SHARDS, SHARD_FRAMES = 4, 60
HAMMING_SHAPES = ((1000, 20000), (600, 20000))
# H100 SXM peaks, NVIDIA's data sheet (dense): device memory, int8 tensor
# cores, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_FLOPS_PER_S = 67e12
# float32 operations of the fuse kernel, each log, log1p and exp counted
# as one: every voxel (sdf, the update gate, |tsdf| and the block min)
# and, on top, every updated voxel (the weighted averages, the log-odds,
# the clamps)
FUSE_OPS_PER_VOXEL, FUSE_OPS_PER_UPDATE = 8, 45
L2_FLUSH_BYTES = 256 * 2**20
_L2_SCRATCH = []


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _flush_l2():
    """Write L2_FLUSH_BYTES of int16 scratch: an int16 fill, which no
    timed call launches, so `_device` can leave it out by name."""
    if not _L2_SCRATCH:
        _L2_SCRATCH.append(torch.empty(L2_FLUSH_BYTES // 2, dtype=torch.int16, device="cuda"))
    _L2_SCRATCH[0].fill_(7)


def _median_ms(fn) -> float:
    """Median CUDA-event time of one call over REPEATS calls, each after
    an L2 flush outside its window. The flush keeps the card busy while
    the host enqueues the call, so the window holds little host time."""
    fn()  # warm-up
    times = []
    for _ in range(REPEATS):
        _flush_l2()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def _device(fn):
    """(device ms per call of everything `fn` runs, {kernel name: (mean
    ms, records)}) over REPEATS calls each after an L2 flush, the flush's
    own events left out. The profiler has dropped some of a kernel's
    records from a profile on the card, so a named time is a mean over
    the records that arrived, not a sum over the calls."""
    flush = {e.name for e in _cuda_events(_flush_l2)}

    def calls():
        for _ in range(REPEATS):
            _flush_l2()
            fn()

    names = {}
    for e in _cuda_events(calls):
        if e.name not in flush:
            names.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    total = sum(sum(t) for t in names.values()) / REPEATS
    return total, {n: (float(np.mean(t)), len(t)) for n, t in names.items()}


def _named(by_name, part):
    return sum(t for n, (t, _) in by_name.items() if part in n)


def _bound(nbytes, ops, ops_per_s):
    """(least time in ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _main_path():
    from ra_slam_tpu_torch.pipeline import offline_eval

    args = offline_eval.build_parser().parse_args(["--synthetic"])
    ds = offline_eval.load_dataset(args)
    return ds, offline_eval.system_config(ds.camera, args).tsdf


def _frame(ds, i, dev):
    from ra_slam_tpu_torch.core.se3 import SE3

    f = ds.frame(i)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(f.rgb), t(f.depth), t(f.ht), t(f.lt), SE3.from_matrix(t(f.cam_T_world))


def _fuse_at_main_path(dev):
    """(map, config, camera, frame) of the main path's frame 10, allocated."""
    from ra_slam_tpu_torch.map import voxel_map as vm

    ds, cfg = _main_path()
    m = vm.create_map(cfg, dev)
    for i in range(FRAMES_BEFORE):
        rgb, depth, ht, lt, pose = _frame(ds, i, dev)
        vm.integrate_frame(m, rgb, depth, ht, lt, ds.camera, pose, cfg, alloc_stride=2)
    frame = _frame(ds, FRAMES_BEFORE, dev)
    vm.allocate_from_depth(m, frame[1], ds.camera, frame[4], cfg, 2)
    return m, cfg, ds.camera, frame


def _fuse_at_one_shard(dev):
    """(shard 0, its config, camera, frame) of frame 60 after the main
    path's 60 frames over 4 hash shards, shard 0's keys allocated."""
    from ra_slam_tpu_torch.map import voxel_map as vm
    from ra_slam_tpu_torch.map.blocks import INVALID_KEY, owner_of
    from ra_slam_tpu_torch.parallel import LocalMesh, create_sharded_map, local_config, make_sharded_integrate_step

    ds, cfg = _main_path()
    mesh = LocalMesh(SHARDS, dev)
    shards = create_sharded_map(cfg, mesh)
    step = make_sharded_integrate_step(mesh, cfg, alloc_stride=2)
    for i in range(SHARD_FRAMES):
        rgb, depth, ht, lt, pose = _frame(ds, i, dev)
        shards, _ = step(shards, rgb, depth, ht, lt, ds.camera, pose)
    lcfg = local_config(cfg, SHARDS)
    frame = _frame(ds, SHARD_FRAMES, dev)
    keys = vm.depth_to_candidate_keys(frame[1], ds.camera, frame[4], lcfg, 2)
    vm.allocate_keys(shards[0], torch.where(owner_of(keys, SHARDS) == 0, keys, INVALID_KEY))
    return shards[0], lcfg, ds.camera, frame


def fuse_numbers(label, m, cfg, cam, frame, card) -> dict:
    """The fuse kernel and its plain version on one frame into `m` (cull
    and prep first), each on its own copy of the payload."""
    from ra_slam_tpu_torch.map import voxel_map as vm

    rgb, depth, ht, lt, pose = frame
    H, W = depth.shape
    vis_idx, vis_mask, count = vm.visible_blocks(m, cam, pose, cfg)
    pix, z, d2r, gate = vm.integrate_prep(m, vis_idx, vis_mask, H, W, cam, pose, cfg)
    img6 = vm.image_planes(rgb, depth, ht, lt)
    args = (vis_idx, vis_mask, img6, pix, z, d2r, gate, cfg)
    copy = lambda: dataclasses.replace(m, tsdf=m.tsdf.clone(), weight=m.weight.clone(), prob=m.prob.clone(),
                                       rgb=m.rgb.clone())
    mk, mp = copy(), copy()
    tsdf_fuse.tsdf_fuse_(mk, *args)
    rows = vis_idx[vis_mask].long()
    n_vis, updated = int(count), int((mk.weight[rows] != m.weight[rows]).sum())
    kernel = lambda: tsdf_fuse.tsdf_fuse_(mk, *args)
    plain = lambda: tsdf_fuse.tsdf_fuse_plain_(mp, *args)
    ms, plain_ms = _median_ms(kernel), _median_ms(plain)
    (call_dev, kdev), (plain_dev, _) = _device(kernel), _device(plain)
    kernel_dev, n_rec = _named(kdev, "tsdf_fuse"), sum(c for n, (_, c) in kdev.items() if "tsdf_fuse" in n)
    # bytes the kernel reads and writes, prep arrays included: per voxel
    # the pool state (6 x 4 B) and the prep (pix, z, d2r, gate: 4 x 4 B)
    # read once, the image read once, the updated voxels' state written
    kernel_bytes = n_vis * 512 * 40 + img6.numel() * 4 + updated * 24
    least_bytes = fuse_bytes(n_vis, updated, H, W)
    ops = n_vis * 512 * FUSE_OPS_PER_VOXEL + updated * FUSE_OPS_PER_UPDATE
    bound_ms, bound_by = _bound(kernel_bytes, ops, F32_FLOPS_PER_S)
    print(
        f"tsdf_fuse at {label}: {n_vis} visible blocks, {updated} voxels updated; per call (median of "
        f"{REPEATS}, CUDA events, index validation included) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"device time (profiler, mean) kernel {kernel_dev:.4f} ms ({n_rec} of {REPEATS} records), the "
        f"kernel's call {call_dev:.4f} ms, plain {plain_dev:.4f} ms; bytes the kernel reads and writes, prep "
        f"arrays included, {kernel_bytes / 1e6:.1f} MB ({kernel_bytes / (kernel_dev / 1e3) / 1e9:.1f} GB/s), "
        f"{ops / 1e6:.1f} M float32 ops: bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / kernel_dev:.3f} "
        f"(device), {bound_ms / ms:.3f} (per call); the fusion's least traffic (benchmark/harness/work.py:"
        f"fuse_bytes) {least_bytes / 1e6:.1f} MB, share {least_bytes / HBM_BYTES_PER_S * 1e3 / kernel_dev:.3f}; "
        f"{card}"
    )
    return {"visible_blocks": n_vis, "updated_voxels": updated, "ms": ms, "plain_ms": plain_ms,
            "device_ms": kernel_dev, "kernel_bytes": kernel_bytes, "fuse_bytes": least_bytes,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / kernel_dev}


def _pm1_product(a_pm1, b_pm1):
    """The library yardstick of the Hamming kernel, never called by the
    port: one PyTorch call of the +-1 product that the JAX package takes
    off the TPU, writing the same float32 [Ka, Kb] bytes. bf16 operands
    with a float32 product (`torch.mm(..., out_dtype=)`) where this torch
    has it, else float32 operands with TF32 allowed for that call only.
    Returns (call, route)."""
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


def hamming_numbers(ka, kb, dev, card) -> dict:
    from ra_slam_tpu_torch.features.matching import unpack_pm1

    rng = np.random.default_rng(0)
    words = lambda n: torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8), dtype=np.int64).astype(np.int32),
                                      device=dev)
    a, b = words(ka), words(kb)
    k = hamming.hamming_matrix(a, b)
    lib, route = _pm1_product(unpack_pm1(a), unpack_pm1(b))
    if not torch.equal((256.0 - lib()) / 2, k):
        raise AssertionError(f"the +-1 product ({route}) differs from the kernel at {ka}x{kb}")
    kern = lambda: hamming.hamming_matrix(a, b)
    filled = torch.empty_like(k)
    fill = lambda: filled.fill_(1.0)
    ms, lib_ms = _median_ms(kern), _median_ms(lib)
    (_, kdev), (lib_dev, _), (fill_dev, _) = _device(kern), _device(lib), _device(fill)
    kernel_dev = _named(kdev, "hamming")
    n_rec = sum(c for n, (_, c) in kdev.items() if "hamming" in n)
    # the work as a +-1 int8 product (2 * 256 operations an output): the
    # data sheet gives no binary tensor-core rate
    bound_ms, bound_by = _bound(k.numel() * 4 + (ka + kb) * 32, k.numel() * 512, INT8_OPS_PER_S)
    print(
        f"hamming at {ka}x{kb}: per call (median of {REPEATS}, CUDA events) kernel {ms:.4f} ms, library "
        f"({route}) {lib_ms:.4f} ms; device time (profiler, mean) kernel {kernel_dev:.4f} ms ({n_rec} of "
        f"{REPEATS} records), library {lib_dev:.4f} ms, fill_ of the output {fill_dev:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}, the float32 output); share: kernel {bound_ms / kernel_dev:.3f} "
        f"(device), {bound_ms / ms:.3f} (per call), library {bound_ms / lib_dev:.3f}, fill_ "
        f"{bound_ms / fill_dev:.3f} (device); {card}"
    )
    return {"ms": ms, "device_ms": kernel_dev, "library_ms": lib_ms, "library_device_ms": lib_dev,
            "fill_device_ms": fill_dev, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / kernel_dev}


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_torch_kernels: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = _smi()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc a source, together
        for job in [pool.submit(_build.load_library, name) for name in KERNELS]:
            job.result()  # re-raises a failed build
    for name in KERNELS:
        s = _build.BUILD_SECONDS.get(name)
        print(f"{name} build: " + (f"nvcc {s:.2f} s" if s is not None else "library of these sources already built"))
        print((_build.library_dir(name) / "build.log").read_text().strip())
    print(f"builds done in {time.perf_counter() - t0:.2f} s (in parallel)")

    fuse = {"main_path": fuse_numbers(f"the main path's frame {FRAMES_BEFORE}", *_fuse_at_main_path(dev), card)}
    torch.cuda.empty_cache()
    fuse["one_shard"] = fuse_numbers(f"shard 0 of {SHARDS} (frame {SHARD_FRAMES})", *_fuse_at_one_shard(dev), card)
    torch.cuda.empty_cache()
    ham = {f"{ka}x{kb}": hamming_numbers(ka, kb, dev, card) for ka, kb in HAMMING_SHAPES}
    print(json.dumps({"kernels": [
        {"name": "tsdf_fuse", "route": "cuda", "source": "ra_slam_tpu_torch/csrc/tsdf_fuse.cu",
         "replaces": "ra_slam_tpu/ops/tsdf_pallas.py:156", **fuse},
        {"name": "hamming", "route": "cuda", "source": "ra_slam_tpu_torch/csrc/hamming.cu",
         "replaces": "ra_slam_tpu/ops/hamming.py:52", **ham},
    ], "device": torch.cuda.get_device_name(0), "card": card}))


if __name__ == "__main__":
    main()
