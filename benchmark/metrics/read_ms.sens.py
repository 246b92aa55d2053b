"""`read_ms.sens`: host milliseconds a frame inside `SensReader.frame`
(pread, zlib depth, nvjpeg colour, colour resize on the host), the mean
over the run's frames outside the traced stretch. Source: the harness's
host span around each call. Moves `fused_fps`."""

SOURCE, UNIT, MOVES = "program_span", "ms", "fused_fps"


def read(out, cell):
    xs = out["spans"].get("read") or []
    return 1e3 * sum(xs) / len(xs) if xs else None
