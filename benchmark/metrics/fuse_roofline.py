"""`fuse_roofline`: the fuse kernel's share of its roofline, in percent.

The least time of a frame's fusion is its least device-memory traffic
over the H100's 3.35 TB/s (`benchmark/harness/work.py:fuse_bytes`):
counted from the fusion's semantics, not from the program's arrays. That
is every visible voxel's tsdf read once (for the block's least |tsdf|,
which carving reads), the rest of the payload (weight, prob, rgb) read
and the whole payload (24 B) written for each voxel the frame updates,
plus the frame's depth, colour and ht / lt read once. The visible blocks
and updated voxels of each traced frame are the reference's
(`fusion_work`: its replay of the same frames at the same poses). The
program's per-voxel prep arrays (pixel, depth, range scale, gate) are not
counted, so a program that folds the prep into the kernel is judged
against the same work. The time is the profiler's device time of
`tsdf_fuse_kernel` in the traced stretch: the mean bound of a traced
frame over the mean time of a kernel record. Source: device trace.
Moves `fused_fps`."""

import numpy as np

from benchmark.harness.work import HBM_BYTES_PER_S, fuse_bytes

SOURCE, UNIT, MOVES = "device_trace", "%", "fused_fps"
KERNEL = "tsdf_fuse_kernel"


def read(out, cell):
    tr = out.get("trace")
    work = out["counters"].get("traced_work") or []
    if tr is None or not work:
        return None
    t = sum(s for name, s in tr.kernel_s.items() if KERNEL in name)
    n = sum(c for name, c in tr.kernel_n.items() if KERNEL in name)
    if n == 0 or t <= 0:
        return None
    h, w = cell.config["depth_camera"]["height"], cell.config["depth_camera"]["width"]
    bound_s = float(np.mean([fuse_bytes(v, u, h, w) for v, u in work])) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (t / n)
