"""`launches_per_frame.fuse`: kernel launches a fused frame, counted as the
host-side `cudaLaunchKernel` / `cuLaunchKernel` runtime events of the
profiler's trace over the traced stretch's frames (host events: the
profiler does not deliver every device record). Source: device trace.
Moves `fused_fps`: the host's dispatch bounds a frame."""

SOURCE, UNIT, MOVES = "device_trace", "count", "fused_fps"


def read(out, cell):
    tr = out.get("trace")
    if tr is None or tr.frames == 0 or tr.launches == 0:
        return None
    return tr.launches / tr.frames
