"""Where the time of the PyTorch port's known-pose fusion step goes, on one
NVIDIA GPU, at the offline_eval defaults (VGA synthetic orbit, 1 cm
voxels, 2^17 blocks).

    python3 scripts/profile_torch_fusion.py

Frames are rendered on the host before any timing, so the rates are those
of `RaSlamSystem.feed_rgbd_frame` alone (upload included). Prints:
  - fused frames/s over frames 5..59, three fresh maps in turn;
  - for frames 10..29 under torch.profiler: the device's busy share of
    the wall time (union of kernel and copy intervals), and device time
    by kernel family.
Every line ends with the card's nvidia-smi name and power limit.
"""

import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ra_slam_tpu_torch.core.se3 import SE3  # noqa: E402
from ra_slam_tpu_torch.pipeline import offline_eval  # noqa: E402
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem  # noqa: E402

N_FRAMES = 60
WARM = 5
PROFILED = (10, 30)

# kernel-name substrings -> family, first match wins
FAMILIES = (
    ("tsdf_fuse", "tsdf_fuse (CUDA kernel of this repo)"),
    ("gemm", "matmul (rigid transforms)"),
    ("Memcpy HtoD", "copy host->device"),
    ("Memcpy DtoH", "copy device->host"),
    ("radix", "sort"),
    ("sort", "sort"),
    ("scan", "scan (cumsum)"),
    ("index", "index/gather/scatter"),
    ("gather", "index/gather/scatter"),
    ("scatter", "index/gather/scatter"),
    ("reduce", "reductions"),
    ("CatArray", "cat/stack"),
    ("elementwise", "elementwise"),
)


def _family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key.lower() in low:
            return fam
    return name[:80]


def _busy_us(events) -> float:
    """Length of the union of the events' device intervals."""
    busy, cur = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (cur[1] - cur[0] if cur else 0.0)


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_fusion: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    args = offline_eval.build_parser().parse_args(["--synthetic"])
    ds = offline_eval.load_dataset(args)
    cfg = offline_eval.system_config(ds.camera, args)
    t0 = time.perf_counter()
    frames = [ds.frame(i) for i in range(N_FRAMES)]
    t_render = time.perf_counter() - t0
    print(f"host render of {N_FRAMES} VGA frames: {t_render:.3f} s "
          f"({t_render / N_FRAMES * 1e3:.2f} ms/frame)")

    def run(s, lo, hi):
        for fr in frames[lo:hi]:
            pose = SE3.from_matrix(torch.as_tensor(fr.cam_T_world))
            s.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, pose=pose, ht=fr.ht, lt=fr.lt)
        s.synchronize()

    for rep in range(3):
        s = RaSlamSystem(cfg, "cuda", enable_tracking=False)
        run(s, 0, WARM)
        t0 = time.perf_counter()
        run(s, WARM, N_FRAMES)
        dt = time.perf_counter() - t0
        n = N_FRAMES - WARM
        print(f"rep {rep}: frames {WARM}..{N_FRAMES - 1}: {n / dt:.2f} fused frames/s, "
              f"{dt / n * 1e3:.3f} ms/frame; {s.last_stats}; {card}")
        del s

    s = RaSlamSystem(cfg, "cuda", enable_tracking=False)
    lo, hi = PROFILED
    run(s, 0, lo)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(s, lo, hi)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(dev)
    print(f"profiled frames {lo}..{hi - 1}: wall {wall_us / 1e3:.1f} ms "
          f"({wall_us / (hi - lo) / 1e3:.2f} ms/frame, profiler on), device busy "
          f"{busy / 1e3:.1f} ms = {busy / wall_us:.3f} of wall, {len(dev)} device events; {card}")
    fams = {}
    for e in dev:
        f = fams.setdefault(_family(e.name), [0.0, 0])
        f[0] += e.time_range.elapsed_us()
        f[1] += 1
    total = sum(us for us, _ in fams.values())
    for name, (us, n) in sorted(fams.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3:9.3f} ms  {100 * us / total:5.1f}%  x{n:5d}  {name}")


if __name__ == "__main__":
    main()
