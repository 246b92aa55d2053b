"""`track_call_ms.rgbd`: host milliseconds from the call of
`RaSlamSystem.feed_tracking_frame` to the frame's `tracked` flag on the
host (the RGB-D tracking path: pyramid, FAST, ORB, matching, GN,
keyframes, BA, loop closing), the mean over the frames outside the
traced stretch. Source: the harness's host span around each call. Moves
`track_ms_p95`."""

SOURCE, UNIT, MOVES = "program_span", "ms", "track_ms_p95"


def read(out, cell):
    xs = out["spans"].get("track") or []
    return 1e3 * sum(xs) / len(xs) if xs else None
