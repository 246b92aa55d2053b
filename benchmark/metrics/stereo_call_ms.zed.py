"""`stereo_call_ms.zed`: host milliseconds a ZED pair from
`RaSlamSystem.feed_stereo_frame` to its `tracked` flag on the host
(upload, ORB on the left view, stereo keypoint depth, the tracking step),
the mean over the pairs outside the traced stretch. Source: the
harness's host span around each call. Moves `track_ms_p95`."""

SOURCE, UNIT, MOVES = "program_span", "ms", "track_ms_p95"


def read(out, cell):
    xs = out["spans"].get("stereo_call") or []
    return 1e3 * sum(xs) / len(xs) if xs else None
