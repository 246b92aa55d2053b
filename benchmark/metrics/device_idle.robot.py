"""`device_idle.robot`: the share of the traced stretch of the robot's
replay, in percent, in which no operation ran on the device: 100 (1 -
busy / window), busy the union of the profiler's device-event intervals.
The stretch is whole cycles (two tracked ZED pairs and one fused L515
frame). Source: device trace. Moves `fused_fps` (a cycle's length; its
two tracking calls move `track_ms_p95` as well)."""

SOURCE, UNIT, MOVES = "device_trace", "%", "fused_fps"


def read(out, cell):
    tr = out.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
