"""Where the time of the PyTorch port's RGB-D tracking goes, on one NVIDIA
GPU, in the configuration of `ra_slam_tpu_torch.eval.trajectory_bench
--no-loop` at VGA (600 keypoints on 4 levels, 20000 landmarks, 256
keyframes).

    python3 scripts/profile_torch_tracking.py

Frames are rendered on the host before any timing. Prints:
  - tracked frames/s over frames 5..59, and per frame the time of ORB
    detection and of the frame step, each closed by a device sync;
  - for frames 20..39 under torch.profiler: the device's busy share of
    the wall, device time by kernel family, and the host ops with the
    most self CPU time.
Every line ends with the card's nvidia-smi name and power limit.
"""

import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_torch_fusion import _busy_us  # noqa: E402
from ra_slam_tpu_torch.core.se3 import SE3  # noqa: E402
from ra_slam_tpu_torch.eval.trajectory_bench import tracking_setup  # noqa: E402
from ra_slam_tpu_torch.features.orb import detect_and_describe  # noqa: E402
from ra_slam_tpu_torch.features.pyramid import rgb_to_gray  # noqa: E402
from ra_slam_tpu_torch.slam import system  # noqa: E402

N_FRAMES = 60
WARM = 5
PROFILED = (20, 40)

FAMILIES = (
    ("hamming", "hamming (CUDA kernel of this repo)"),
    ("gemm", "matmul"),
    ("Memcpy HtoD", "copy host->device"),
    ("Memcpy DtoH", "copy device->host"),
    ("sort", "sort"),
    ("getrf", "linalg (LU solves)"),
    ("getrs", "linalg (LU solves)"),
    ("trsm", "linalg (LU solves)"),
    ("lu", "linalg (LU solves)"),
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


def _smi() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_tracking: no CUDA device")
    card = _smi()
    ds, s = tracking_setup(640, 480, device="cuda", loop_closure=False)
    frames = [ds.frame(i) for i in range(N_FRAMES)]
    dev = s.device

    def feed(i):
        fr = frames[i]
        hint = SE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
        return s.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=hint)

    for i in range(WARM):
        feed(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARM, PROFILED[0]):
        feed(i)
    torch.cuda.synchronize()
    n = PROFILED[0] - WARM
    dt = time.perf_counter() - t0
    print(f"frames {WARM}..{PROFILED[0] - 1}: {n / dt:.2f} tracked frames/s, "
          f"{dt / n * 1e3:.2f} ms/frame; {card}")

    # one frame split into its two parts, each closed by a device sync
    fr = frames[PROFILED[0]]
    t0 = time.perf_counter()
    kp = detect_and_describe(rgb_to_gray(torch.as_tensor(fr.rgb).to(dev)), s.fcfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    depth = torch.as_tensor(fr.depth).to(dev)
    fid = torch.full((), PROFILED[0], dtype=torch.int32, device=dev)
    ts = torch.full((), fr.timestamp, dtype=torch.float32, device=dev)
    state, _ = system.slam_frame_step(s.state, kp, depth, fid, ts, SE3.identity(dev), s.cam, s.tcfg, s.params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"frame {PROFILED[0]} (not kept): ORB detect {1e3 * (t1 - t0):.2f} ms, "
          f"frame step {1e3 * (t2 - t1):.2f} ms; {card}")

    lo, hi = PROFILED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(lo, hi):
            feed(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(evs)
    print(f"profiled frames {lo}..{hi - 1}: wall {wall_us / 1e3:.1f} ms "
          f"({wall_us / (hi - lo) / 1e3:.2f} ms/frame, profiler on), device busy "
          f"{busy / 1e3:.1f} ms = {busy / wall_us:.3f} of wall, "
          f"{len(evs) / (hi - lo):.0f} device events/frame; {card}")
    fams = {}
    for e in evs:
        f = fams.setdefault(_family(e.name), [0.0, 0])
        f[0] += e.time_range.elapsed_us()
        f[1] += 1
    total = sum(us for us, _ in fams.values())
    for name, (us, k) in sorted(fams.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3:9.3f} ms  {100 * us / total:5.1f}%  x{k:5d}  {name}")
    print("host ops by self CPU time (top 15):")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))


if __name__ == "__main__":
    main()
