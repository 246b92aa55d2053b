"""`launches_per_frame.track`: kernel launches a frame of the tracked
replay (tracking and fusion), counted as the host-side
`cudaLaunchKernel` / `cuLaunchKernel` runtime events of the profiler's
trace over the traced stretch's frames (host events: the profiler does
not deliver every device record). Source: device trace. Moves
`track_ms_p95`: tracking's host dispatch bounds a frame."""

SOURCE, UNIT, MOVES = "device_trace", "count", "track_ms_p95"


def read(out, cell):
    tr = out.get("trace")
    if tr is None or tr.frames == 0 or tr.launches == 0:
        return None
    return tr.launches / tr.frames
