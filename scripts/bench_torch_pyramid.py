"""The ORB pyramid's cost on one NVIDIA GPU, and the tracked frames/s of
`chip_smoke.py` phase 5 (`ra_slam_tpu_torch.eval.trajectory_bench
--no-loop` over 150 VGA frames: 600 keypoints on 4 levels).

    python3 scripts/bench_torch_pyramid.py [--root DIR] [--frames 150]

`--root` imports the port from another checkout (an unpacked parent
commit, say), so that two versions are compared within one call. On a
VGA frame of the synthetic orbit, the 4-level pyramid of the tracking
path: the operations it dispatches to the card (aten calls on CUDA
tensors, counted by a dispatch mode), the device events the profiler
records (kernels and host-to-device copies) and its median time over 20
calls with CUDA events. Prints one JSON line ending with the card's
nvidia-smi name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--frames", type=int, default=150)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from ra_slam_tpu_torch.eval import trajectory_bench
    from ra_slam_tpu_torch.features.pyramid import build_pyramid, rgb_to_gray
    from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset

    assert trajectory_bench.__file__.startswith(os.path.abspath(args.root)), trajectory_bench.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            tensors = [a for a in list(args) + [out] if isinstance(a, torch.Tensor)]
            self.ops += any(t.is_cuda for t in tensors)
            return out

    gray = rgb_to_gray(torch.as_tensor(SyntheticBoxDataset(num_frames=60).frame(1).rgb)).cuda()
    build_pyramid(gray, 4)  # first call: the tables
    torch.cuda.synchronize()
    with Count() as count:
        build_pyramid(gray, 4)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        build_pyramid(gray, 4)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    uploads = sum("HtoD" in e.name for e in dev)
    times = []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        build_pyramid(gray, 4)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    t0 = time.perf_counter()
    r = trajectory_bench.main(["--width", "640", "--height", "480", "--no-loop", "--frames", str(args.frames)])
    print(json.dumps({
        "root": args.root,
        "pyramid_device_ops": count.ops,
        "pyramid_profiler_kernels": len(dev) - uploads,
        "pyramid_profiler_uploads": uploads,
        "pyramid_ms_median": sorted(times)[len(times) // 2],
        "tracked_fps": r["steady_state_fps"],
        "lost_frames": r["lost_frames"],
        "ate_rmse_m": r["ate_rmse_m"],
        "track_wall_s": time.perf_counter() - t0,
        "card": card,
    }))


if __name__ == "__main__":
    main()
