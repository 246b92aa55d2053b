"""`dense_stereo_roofline`: the dense stereo stage's share of its
roofline, in percent.

The least time of a pair's dense depth is the larger of its bytes over
the H100's 3.35 TB/s and its operations over 66.9 TFLOP/s of float32
(`benchmark/harness/stereo_work.py`, counted from the shapes: the
configuration's rectified ZED size, `max_disparity` and `block`). The
time is the profiler's device time of the work the program launched
inside its `ra.stereo.dense` ranges in the traced stretch, over the
number of those ranges: the mean a pair. Source: device trace. Moves
`fused_fps`. None where the program has no such range."""

from benchmark.harness.stereo_work import least_seconds

SOURCE, UNIT, MOVES = "device_trace", "%", "fused_fps"


def read(out, cell):
    dense = out.get("dense") or {}
    if not dense.get("calls") or dense.get("device_s", 0.0) <= 0:
        return None
    z, ds = cell.config["zed"], cell.config["dense_stereo"]
    bound_s = least_seconds(z["height"], z["width"], ds["max_disparity"], ds["block"])
    return 100.0 * bound_s / (dense["device_s"] / dense["calls"])
