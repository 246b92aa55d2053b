"""`hamming_device_ms`: device milliseconds a frame of the match kernel
(`csrc/hamming.cu:hamming_popc_mma_kernel`) on the tracking path, the
profiler's device time of its records in the traced stretch over the
stretch's frames. Source: device trace. Moves `track_ms_p95`."""

SOURCE, UNIT, MOVES = "device_trace", "ms", "track_ms_p95"
KERNEL = "hamming"


def read(out, cell):
    tr = out.get("trace")
    if tr is None or tr.frames == 0:
        return None
    t = sum(s for name, s in tr.kernel_s.items() if KERNEL in name)
    return 1e3 * t / tr.frames if t > 0 else None
